"""The port's sharded MoE dispatch (``moe_ffn_sharded``), against the JAX
package's ``shard_map`` version.

The JAX side runs in one subprocess with ``JAX_PLATFORMS=cpu`` and
``XLA_FLAGS=--xla_force_host_platform_device_count=8``, each case under
``jax.set_mesh`` and jitted with ``xla_allow_excess_precision`` off; the
results come back through an ``.npz``.  The port runs the same parameters
and tokens over a ``Mesh`` of CPU entries of the same shape.  The cases
cover each placement: tensor parallel inside the experts (granite's 5
experts on a model axis of 2), expert parallel (5 on 5, phi's 4 on 2),
padded expert parallel (``ep_pad`` at 2), two data shards (capacity per
data shard, the aux loss summed over ``data``), a decode-size token count
that does not split over ``data`` (replicated), no ``dp_spec`` at all,
and (1, 1).  Outputs agree within ``test_torch_lm_models.py``'s 2e-2 and
the aux loss within 1e-6 relative; at (1, 1) the output equals the
unsharded ``moe_ffn`` at ``num_groups=1`` exactly.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_arch as get_arch_jax
from repro.models import transformer as TJ

from repro_torch.configs import get_arch
from repro_torch.distributed import Mesh
from repro_torch.models import moe as MT
from repro_torch.models.convert import lm_params_from_numpy

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=2e-2, atol=2e-2)
#: (name, experts, top_k, (data, model), dp_spec, ep_pad, tokens)
CASES = [("tp_inside_1x2", 5, 2, (1, 2), "data", False, 24),
         ("tp_inside_2x2", 5, 2, (2, 2), "data", False, 24),
         ("ep_1x5", 5, 2, (1, 5), "data", False, 24),
         ("ep_pad_1x2", 5, 2, (1, 2), "data", True, 24),
         ("ep_2x2", 4, 2, (2, 2), "data", False, 24),
         ("decode_2x2", 5, 2, (2, 2), "data", False, 3),
         ("no_dp_2x2", 5, 2, (2, 2), None, False, 24),
         ("top1_2x4", 8, 1, (2, 4), "data", False, 40),
         ("one_1x1", 5, 2, (1, 1), "data", False, 24)]
D_MODEL, D_FF, CF = 64, 32, 1.25

_REPRO = r"""
import json, sys
import jax, jax.numpy as jnp, ml_dtypes, numpy as np
from jax.sharding import Mesh
from repro.models.moe import init_moe, moe_ffn_sharded

cases = json.load(open(sys.argv[1]))
arrs = dict(np.load(sys.argv[2]))
out = {}
for name, E, k, (dd, mm), dp, pad, T in cases:
    p = init_moe(jax.random.key(E), arrs["d"].item(), arrs["f"].item(), E)
    for w, v in p.items():
        out[f"{name}_p_{w}"] = np.asarray(v.astype(jnp.float32))
    x = jnp.asarray(arrs[f"x_{name}"]).astype(jnp.bfloat16)
    mesh = Mesh(np.array(jax.devices()[:dd * mm]).reshape(dd, mm),
                ("data", "model"))
    with jax.set_mesh(mesh):
        f = jax.jit(lambda p, x: moe_ffn_sharded(
            p, x, n_experts=E, top_k=k, capacity_factor=arrs["cf"].item(),
            mesh=mesh, dp_spec=dp, tp_axis="model", ep_pad=pad),
            compiler_options={"xla_allow_excess_precision": False})
        y, aux = f(p, x)
    out[f"{name}_out"] = np.asarray(y.astype(jnp.float32))
    out[f"{name}_aux"] = np.asarray(aux)
np.savez(sys.argv[3], **out)
"""


@pytest.fixture(scope="module")
def repro_side(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe")
    rng = np.random.default_rng(5)
    arrays = {"d": np.asarray(D_MODEL), "f": np.asarray(D_FF),
              "cf": np.asarray(CF)}
    for c in CASES:
        x = rng.standard_normal((c[6], D_MODEL)).astype(np.float32)
        arrays[f"x_{c[0]}"] = x.astype(ml_dtypes.bfloat16).astype(np.float32)
    (tmp / "cases.json").write_text(json.dumps(CASES))
    np.savez(tmp / "in.npz", **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=f"{ROOT / 'src'}")
    r = subprocess.run([sys.executable, "-c", _REPRO, str(tmp / "cases.json"),
                        str(tmp / "in.npz"), str(tmp / "out.npz")],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    return arrays, dict(np.load(tmp / "out.npz"))


def _grid(dd: int, mm: int) -> Mesh:
    return Mesh(np.full((dd, mm), "cpu", dtype=object), ("data", "model"))


def _port_case(repro_side, case):
    arrays, out = repro_side
    name = case[0]
    p = {w: torch.from_numpy(out[f"{name}_p_{w}"]).to(
        torch.float32 if w == "router" else torch.bfloat16)
        for w in ("router", "w_gate", "w_up", "w_down")}
    x = torch.from_numpy(arrays[f"x_{name}"]).to(torch.bfloat16)
    return p, x


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_moe_ffn_sharded_equals_repro(repro_side, case):
    name, E, k, (dd, mm), dp, pad, T = case
    _, out = repro_side
    p, x = _port_case(repro_side, case)
    y, aux = MT.moe_ffn_sharded(p, x, n_experts=E, top_k=k,
                                capacity_factor=CF, mesh=_grid(dd, mm),
                                dp_spec=dp, tp_axis="model", ep_pad=pad)
    assert y.shape == (T, D_MODEL) and y.dtype == torch.bfloat16
    np.testing.assert_allclose(y.float().numpy(), out[f"{name}_out"], **TOL)
    np.testing.assert_allclose(aux.numpy(), out[f"{name}_aux"], rtol=1e-6)
    # moe_ffn routes a mesh with a tp axis to the sharded path
    y2, aux2 = MT.moe_ffn(p, x, n_experts=E, top_k=k, capacity_factor=CF,
                          num_groups=3, mesh=_grid(dd, mm), dp_spec=dp,
                          tp_axis="model", ep_pad=pad)
    assert torch.equal(y2, y) and torch.equal(aux2, aux)


def test_one_by_one_equals_unsharded(repro_side):
    case = CASES[-1]
    p, x = _port_case(repro_side, case)
    y, aux = MT.moe_ffn_sharded(p, x, n_experts=5, top_k=2,
                                capacity_factor=CF, mesh=_grid(1, 1),
                                dp_spec="data", tp_axis="model")
    want, aux_w = MT.moe_ffn(p, x, n_experts=5, top_k=2, capacity_factor=CF,
                             num_groups=1)
    assert torch.equal(y, want)
    np.testing.assert_allclose(aux.numpy(), aux_w.numpy(), rtol=1e-6)


@pytest.mark.parametrize("mm", [2, 4])
def test_expert_parallel_is_the_unsharded_capacity(repro_side, mm):
    """At data 1, expert parallel keeps the unsharded capacity: only the
    order of the bf16 sums over a token's experts differs."""
    p, x = _port_case(repro_side, CASES[4])
    y, _ = MT.moe_ffn_sharded(p, x, n_experts=4, top_k=2, capacity_factor=CF,
                              mesh=_grid(1, mm), dp_spec="data",
                              tp_axis="model")
    want, _ = MT.moe_ffn(p, x, n_experts=4, top_k=2, capacity_factor=CF)
    np.testing.assert_allclose(y.float().numpy(), want.float().numpy(), **TOL)


def test_sharded_moe_gradients_flow(repro_side):
    p, x = _port_case(repro_side, CASES[1])
    p = {k: v.clone().requires_grad_() for k, v in p.items()}
    x = x.clone().requires_grad_()
    y, aux = MT.moe_ffn_sharded(p, x, n_experts=5, top_k=2,
                                capacity_factor=CF, mesh=_grid(2, 2),
                                dp_spec="data", tp_axis="model")
    (y.float().square().sum() + aux).backward()
    for t in (*p.values(), x):
        assert t.grad is not None and torch.isfinite(t.grad.float()).all()
    assert float(p["w_down"].grad.float().abs().max()) > 0


@pytest.mark.parametrize("mesh_shape,ep_pad", [((1, 5), False),
                                               ((1, 2), True),
                                               ((2, 1), False)])
def test_meshed_granite_forward_near_unsharded(mesh_shape, ep_pad):
    """The granite smoke LM with the mesh wired in (expert parallel at
    model 5, padded expert parallel at model 2, two data shards) against
    the same parameters unsharded, in as many dispatch groups as data
    shards (the same capacity).  TP inside the experts sums bf16 partial
    outputs, another computation: it is held against ``repro``'s own
    (above, and ``test_torch_distribution.py``'s mesh-wired LM)."""
    name = "granite-moe-3b-a800m"
    params = TJ.init_params(jax.random.key(0),
                            get_arch_jax(name).smoke_config)
    tree = jax.tree.map(np.asarray, params)
    base = get_arch(name).smoke_config
    cfg = dataclasses.replace(base, mesh=_grid(*mesh_shape), dp_spec="data",
                              tp_axis="model", moe_ep_pad=ep_pad)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, base.vocab, (2, 8)).astype(np.int32))
    meshed = lm_params_from_numpy(tree, cfg, "cpu")
    plain = lm_params_from_numpy(tree, dataclasses.replace(
        base, moe_groups=mesh_shape[0]), "cpu")
    lm, am = meshed(toks)
    lp, ap = plain(toks)
    np.testing.assert_allclose(lm.numpy(), lp.numpy(), **TOL)
    last, _ = meshed.prefill(toks)
    np.testing.assert_allclose(last.numpy(), lm[:, -1].numpy(), **TOL)
    np.testing.assert_allclose(am.numpy(), ap.numpy(), rtol=1e-5)
