"""The port's GPipe (``distributed/pipeline.py``) against the JAX
package's ``pipeline_apply`` and ``mlp_reference``.

The JAX side runs in one subprocess with ``JAX_PLATFORMS=cpu`` and
``XLA_FLAGS=--xla_force_host_platform_device_count=8``: the forward and
the gradients (of ``sum(y ** 2)``, for the stacked params and the input)
of ``pipeline_apply`` over a ``stage`` mesh of S devices with M
microbatches, for S in {1, 2, 4} and M in {1, 3, 4}, each jitted as one
``jax.vjp`` under ``jax.set_mesh`` (JAX 0.9 asks for the mesh context to
take the gradient), and of ``mlp_reference``.  The port runs the same params
(``models.convert.mlp_params_from_numpy``) over ``Mesh(["cpu"] * S)``:
forward within 1e-5 and gradients within 1e-4 of both, the tolerances of
the JAX package's own GPipe test.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.distributed import Mesh
from repro_torch.distributed.pipeline import (mlp_reference, mlp_stage_fn,
                                              pipeline_apply,
                                              stack_mlp_params)
from repro_torch.models.convert import mlp_params_from_numpy

ROOT = Path(__file__).resolve().parents[1]
L, D, B = 8, 16, 12
STAGES, MICRO = (1, 2, 4), (1, 3, 4)
FWD, GRAD = dict(rtol=1e-5, atol=1e-5), dict(rtol=1e-4, atol=1e-4)

_REPRO = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.distributed.pipeline import (mlp_reference, mlp_stage_fn,
                                        pipeline_apply, stack_mlp_params)

p = stack_mlp_params(jax.random.key(0), int(sys.argv[1]), int(sys.argv[2]))
x = jax.random.normal(jax.random.key(1), (int(sys.argv[3]), int(sys.argv[2])),
                      jnp.float32)
out = {"w": np.asarray(p["w"]), "b": np.asarray(p["b"]), "x": np.asarray(x)}

def record(tag, f):
    def both(p, x):
        y, back = jax.vjp(f, p, x)
        return y, back(2 * y)
    y, (gp, gx) = jax.jit(both)(p, x)
    out.update({f"{tag}_y": np.asarray(y), f"{tag}_gw": np.asarray(gp["w"]),
                f"{tag}_gb": np.asarray(gp["b"]), f"{tag}_gx": np.asarray(gx)})

record("ref", mlp_reference)
for s in (1, 2, 4):
    mesh = jax.make_mesh((s,), ("stage",))
    for m in (1, 3, 4):
        with jax.set_mesh(mesh):
            record(f"s{s}m{m}", lambda p, x: pipeline_apply(
                mesh, "stage", m, mlp_stage_fn, p, x))
np.savez(sys.argv[4], **out)
"""


@pytest.fixture(scope="module")
def repro_side(tmp_path_factory):
    path = tmp_path_factory.mktemp("gpipe") / "out.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=f"{ROOT / 'src'}")
    r = subprocess.run([sys.executable, "-c", _REPRO, str(L), str(D), str(B),
                        str(path)], capture_output=True, text=True, env=env,
                       cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    return dict(np.load(path))


def _run(fn, params, x):
    p = {k: v.clone().requires_grad_() for k, v in params.items()}
    x = x.clone().requires_grad_()
    y = fn(p, x)
    (y ** 2).sum().backward()
    return y.detach(), p["w"].grad, p["b"].grad, x.grad


@pytest.mark.parametrize("M", MICRO)
@pytest.mark.parametrize("S", STAGES)
def test_pipeline_apply_equals_repro(repro_side, S, M):
    got = repro_side
    params = mlp_params_from_numpy({"w": got["w"], "b": got["b"]}, "cpu")
    x = torch.from_numpy(got["x"])
    mesh = Mesh(["cpu"] * S, ("stage",))
    y, gw, gb, gx = _run(lambda p, x: pipeline_apply(
        mesh, "stage", M, mlp_stage_fn, p, x), params, x)
    for tag in (f"s{S}m{M}", "ref"):
        np.testing.assert_allclose(y.numpy(), got[f"{tag}_y"], **FWD)
        for g, k in ((gw, "gw"), (gb, "gb"), (gx, "gx")):
            np.testing.assert_allclose(g.numpy(), got[f"{tag}_{k}"], **GRAD)


def test_mlp_reference_equals_repro(repro_side):
    got = repro_side
    params = mlp_params_from_numpy({"w": got["w"], "b": got["b"]}, "cpu")
    y, gw, gb, gx = _run(mlp_reference, params, torch.from_numpy(got["x"]))
    np.testing.assert_allclose(y.numpy(), got["ref_y"], **FWD)
    for g, k in ((gw, "gw"), (gb, "gb"), (gx, "gx")):
        np.testing.assert_allclose(g.numpy(), got[f"ref_{k}"], **GRAD)


def test_stack_mlp_params_law_and_pipeline_shapes():
    p = stack_mlp_params(torch.Generator().manual_seed(0), 4, 64,
                         device="cpu")
    assert p["w"].shape == (4, 64, 64) and p["b"].shape == (4, 64)
    assert not p["b"].any()
    assert abs(float(p["w"].std()) - 0.5 / 8) < 0.005
    again = stack_mlp_params(torch.Generator().manual_seed(0), 4, 64,
                             device="cpu")
    assert torch.equal(p["w"], again["w"])
    with pytest.raises(AssertionError):
        pipeline_apply(Mesh(["cpu"] * 2, ("stage",)), "stage", 5,
                       mlp_stage_fn, p, torch.zeros(12, 64))
    with pytest.raises(ValueError, match="split"):
        pipeline_apply(Mesh(["cpu"] * 3, ("stage",)), "stage", 2,
                       mlp_stage_fn, p, torch.zeros(12, 64))
    with pytest.raises(ValueError, match="leaves w and b"):
        mlp_params_from_numpy({"w": np.zeros((1, 2, 2))}, "cpu")
