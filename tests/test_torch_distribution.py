"""The port's partition rules, shards, collectives and the mesh-wired LM,
against the JAX package.

The JAX side runs once, in a subprocess with ``JAX_PLATFORMS=cpu`` and
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` (this process keeps
its one JAX device), and hands its results back through a JSON file and an
``.npz``:

* the rules (``lm_param_spec`` with and without ``kv_replicate``,
  ``zero1_spec``, ``gnn_param_spec``, ``recsys_param_spec``) on every leaf
  of every arch's full and smoke config, ``lm_cache_spec``, ``batch_spec``
  and ``index_partition_spec`` over the port's ``FlatIndex`` and
  ``PagedIndex`` fields, each on ``jax.sharding.AbstractMesh`` (16, 16),
  (2, 16, 16), (2, 2), (1, 1), data-only (4,) and model-only (4,): the
  port's specs must be equal, entry for entry;
* ``NamedSharding`` + ``device_put`` on a (2, 2) mesh of 4 virtual
  devices: each ``addressable_shards`` entry must equal the port's
  ``shard_tensor`` at that device's coordinate;
* ``compressed_psum_with_feedback`` over a ``data`` axis of 2 and 3
  devices, 3 carried steps, run eagerly (jitted, XLA's fused residual
  differs in the last bits from the source's op-by-op rounding): outputs
  and residuals bit for bit;
* the mesh-wired LM (``mesh`` (2, 2), ``dp_spec``, ``tp_axis``,
  ``sp_axis``) of the granite and yi-6b smoke configs, jitted with
  ``lm_param_spec`` shardings and ``xla_allow_excess_precision`` off:
  logits and aux within 2e-2 (``test_torch_lm_models.py``'s tolerance).
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

from strategies import make_lists

from repro.configs import get_arch as get_arch_jax
from repro.models import transformer as TJ

from repro_torch.configs import get_arch, list_archs
from repro_torch.core.index import build_flat_index, build_paged_index
from repro_torch.core.repair import repair_compress
from repro_torch.distributed import P, Mesh, sharding as ST, spmd
from repro_torch.launch import mesh as LM
from repro_torch.models import gnn as GT, recsys as RT
from repro_torch.models import transformer as TT
from repro_torch.models.convert import lm_params_from_numpy
from repro_torch.train.optimizer import compressed_psum_with_feedback
from repro_torch.train.tree import leaves_with_paths

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "1x1": ((1, 1), ("data", "model")),
          "data4": ((4,), ("data",)),
          "model4": ((4,), ("model",))}
BATCHES = (None, 1, 2, 8, 16, 32, 512)
SHARD_SPECS = [(), ("data", "model"), (None, "model"), ("model", None),
               (("data", "model"), None), (None, ("model", "data"))]
PSUM_STEPS = 3
LM_MESHED = ("granite-moe-3b-a800m", "yi-6b")
TOL = dict(rtol=2e-2, atol=2e-2)

_REPRO = r"""
import dataclasses, json, sys
from functools import partial
import jax, jax.numpy as jnp, ml_dtypes, numpy as np
from jax.experimental.shard_map import shard_map
from jax.sharding import AbstractMesh, Mesh, NamedSharding, PartitionSpec as P
from repro.configs import get_arch, list_archs
from repro.distributed import sharding as SH
from repro.models import gnn as G, recsys as R, transformer as T
from repro.train.optimizer import compressed_psum_with_feedback

inp = json.load(open(sys.argv[1]))
arrs = dict(np.load(sys.argv[2]))
res, out = {}, {}
enc = lambda s: [list(e) if isinstance(e, tuple) else e for e in s]
is_p = lambda x: isinstance(x, P)
meshes = {k: AbstractMesh(tuple(s), tuple(n))
          for k, (s, n) in inp["meshes"].items()}

def flat(tree, is_leaf=None):
    fl, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in kp): v for kp, v in fl}

def shapes(arch, cfg):
    init = {"lm": T.init_params, "gnn": G.init_params}.get(arch.family)
    if init is None:
        init = R.deepfm_init if arch.name == "deepfm" else R.seqrec_init
    return jax.eval_shape(lambda k: init(k, cfg), jax.random.key(0))

rules = res["rules"] = {}
caches = res["caches"] = {}
for name in list_archs():
    arch = get_arch(name)
    if arch.family == "repair_ir":
        continue
    for which in ("config", "smoke_config"):
        cfg = getattr(arch, which)
        pshape = shapes(arch, cfg)
        shp = {p: list(s.shape) for p, s in flat(pshape).items()}
        for mk, mesh in meshes.items():
            if arch.family == "lm":
                rule = partial(SH.lm_param_spec, n_experts=cfg.n_experts)
                kv = partial(SH.lm_param_spec, n_experts=cfg.n_experts,
                             kv_replicate=True)
            else:
                rule = kv = {"gnn": SH.gnn_param_spec}.get(
                    arch.family, SH.recsys_param_spec)
            specs = flat(SH.spec_tree(pshape, rule, mesh), is_p)
            kvs = flat(SH.spec_tree(pshape, kv, mesh), is_p)
            rules[f"{name}|{which}|{mk}"] = {
                p: [shp[p], enc(s), enc(kvs[p]),
                    enc(SH.zero1_spec(s, tuple(shp[p]), mesh))]
                for p, s in specs.items()}
            if arch.family == "lm":
                for b in inp["batches"][1:]:
                    for k, s in T.init_cache_shape(cfg, b, 64).items():
                        caches[f"{name}|{which}|{mk}|{b}|{k}"] = [
                            list(s.shape),
                            enc(SH.lm_cache_spec(k, s.shape, mesh, b))]
res["batch"] = {f"{mk}|{nd}|{b}": enc(SH.batch_spec(mesh, nd, b))
                for mk, mesh in meshes.items() for nd in (1, 2, 3)
                for b in inp["batches"]}
res["index"] = {f"{mk}|{p}": enc(SH.index_partition_spec(p, tuple(s), mesh))
                for mk, mesh in meshes.items() for p, s in inp["index"]}

# shards of a (2, 2) mesh of 4 devices, by coordinate
devs = np.array(jax.devices()[:4]).reshape(2, 2)
m22 = Mesh(devs, ("data", "model"))
for j, spec in enumerate(inp["shard_specs"]):
    spec = P(*[tuple(e) if isinstance(e, list) else e for e in spec])
    x = jax.device_put(arrs["shard_x"], NamedSharding(m22, spec))
    for s in x.addressable_shards:
        (i, k), = np.argwhere(devs == s.device)
        out[f"shard{j}_{2 * i + k}"] = np.asarray(s.data)

# compressed psum, eagerly (the source's rounding), 3 carried steps
for n in (2, 3):
    mesh = Mesh(np.array(jax.devices()[:n]), ("data",))
    def body(g, e):
        r, ne = compressed_psum_with_feedback(
            jax.tree.map(lambda t: t[0], g), jax.tree.map(lambda t: t[0], e),
            "data")
        return jax.tree.map(lambda t: t[None], (r, ne))
    f = shard_map(body, mesh=mesh, in_specs=(P("data"), P("data")),
                  out_specs=(P("data"), P("data")), check_rep=False)
    err = {k: np.zeros(arrs[f"psum{n}_0_{k}"].shape, np.float32)
           for k in inp["psum_leaves"]}
    for t in range(inp["psum_steps"]):
        g = {k: arrs[f"psum{n}_{t}_{k}"].astype(
                ml_dtypes.bfloat16 if k.startswith("bf16") else np.float32)
             for k in inp["psum_leaves"]}
        r, err = f(g, err)
        for k in inp["psum_leaves"]:
            out[f"psum{n}_{t}_out_{k}"] = np.asarray(r[k])
            out[f"psum{n}_{t}_err_{k}"] = np.asarray(err[k])

# the mesh-wired LM forward, jitted with lm_param_spec shardings
for name in inp["lm"]:
    base = get_arch(name).smoke_config
    cfg = dataclasses.replace(base, mesh=m22, dp_spec="data",
                              tp_axis="model", sp_axis="model")
    params = T.init_params(jax.random.key(0), base)
    specs = SH.spec_tree(params, partial(SH.lm_param_spec,
                                         n_experts=cfg.n_experts), m22)
    with jax.set_mesh(m22):
        params = jax.device_put(params, SH.shardings_for(specs, m22))
        fwd = jax.jit(lambda p, t: T.forward(p, cfg, t), compiler_options={
            "xla_allow_excess_precision": False})
        logits, aux = fwd(params, arrs[f"lm_{name}"])
    out[f"lm_{name}_logits"] = np.asarray(logits)
    out[f"lm_{name}_aux"] = np.asarray(aux)

json.dump(res, open(sys.argv[3], "w"))
np.savez(sys.argv[4], **out)
"""


def run_repro(prog: str, tmp: Path, inp: dict, arrays: dict,
              timeout: int = 300):
    """``prog`` in a subprocess with 8 virtual CPU devices: it reads
    ``inp`` (JSON) and ``arrays`` (npz) and writes a JSON and an npz."""
    (tmp / "in.json").write_text(json.dumps(inp))
    np.savez(tmp / "in.npz", **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=f"{ROOT / 'src'}")
    files = [str(tmp / f) for f in ("in.json", "in.npz", "out.json",
                                    "out.npz")]
    r = subprocess.run([sys.executable, "-c", prog, *files],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=timeout)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads((tmp / "out.json").read_text()), \
        dict(np.load(tmp / "out.npz"))


def _index_fields():
    res = repair_compress(make_lists(np.random.default_rng(7)))
    fi = build_flat_index(res, device="cpu")
    pi = build_paged_index(fi, page_size=128)
    return [(f"{kind}/{k}", list(v.shape))
            for kind, idx in (("flat", fi), ("paged", pi))
            for k, v in sorted(vars(idx).items())
            if isinstance(v, torch.Tensor)]


def _psum_inputs(rng) -> dict:
    """Three steps of gradients, each shard at its own scale (so the
    max-reduced scale differs from the local ones)."""
    leaves = {"f32_w": (6, 40), "bf16_g": (130,), "f32_s": ()}
    out = {}
    for n in (2, 3):
        scale = np.asarray([1.0, 7.5, 0.03][:n], np.float32)
        for t in range(PSUM_STEPS):
            for k, shp in leaves.items():
                a = rng.standard_normal((n, *shp)).astype(np.float32) * \
                    scale.reshape((n,) + (1,) * len(shp))
                if k.startswith("bf16"):
                    a = a.astype(ml_dtypes.bfloat16).astype(np.float32)
                out[f"psum{n}_{t}_{k}"] = a
    return out, list(leaves)


@pytest.fixture(scope="module")
def repro_side(tmp_path_factory):
    rng = np.random.default_rng(11)
    psum_in, psum_leaves = _psum_inputs(rng)
    arrays = dict(psum_in, shard_x=rng.standard_normal((8, 12)).astype(
        np.float32))
    for name in LM_MESHED:
        cfg = get_arch(name).smoke_config
        arrays[f"lm_{name}"] = rng.integers(0, cfg.vocab, (2, 16)).astype(
            np.int32)
    inp = dict(meshes={k: [list(s), list(n)] for k, (s, n) in MESHES.items()},
               batches=list(BATCHES), index=_index_fields(),
               shard_specs=[[list(e) if isinstance(e, tuple) else e
                             for e in s] for s in SHARD_SPECS],
               psum_leaves=psum_leaves, psum_steps=PSUM_STEPS,
               lm=list(LM_MESHED))
    res, out = run_repro(_REPRO, tmp_path_factory.mktemp("dist"), inp,
                         arrays)
    return res, out, arrays


def _mesh(key: str) -> Mesh:
    shape, names = MESHES[key]
    return Mesh(np.full(shape, "cpu", dtype=object), names)


def _dec(spec) -> P:
    return P(*[tuple(e) if isinstance(e, list) else e for e in spec])


def _flat_specs(tree, prefix=""):
    """``{path: spec}`` of a tree of specs (a spec is a tuple itself)."""
    if isinstance(tree, P):
        return {prefix: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_flat_specs(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _port_tree(name: str, which: str):
    arch = get_arch(name)
    cfg = getattr(arch, which)
    if arch.family == "lm":
        return TT.init_params_shape(cfg), cfg
    if arch.family == "gnn":
        return GT.init_params(cfg, None, device="meta"), cfg
    init = RT.deepfm_init if name == "deepfm" else RT.seqrec_init
    return init(cfg, None, device="meta"), cfg


RULE_ARCHS = [a for a in list_archs() if get_arch(a).family != "repair_ir"]


# -- the rules ------------------------------------------------------------------

@pytest.mark.parametrize("mk", list(MESHES))
@pytest.mark.parametrize("name", RULE_ARCHS)
def test_param_rules_equal_repro(repro_side, name, mk):
    """Every leaf of the full and the smoke config: the rule's spec (and
    the LM's with ``kv_replicate``) through ``spec_tree``, and
    ``zero1_spec`` of it, equal ``repro``'s on the AbstractMesh."""
    res = repro_side[0]
    mesh = _mesh(mk)
    fam = get_arch(name).family
    for which in ("config", "smoke_config"):
        want = res["rules"][f"{name}|{which}|{mk}"]
        tree, cfg = _port_tree(name, which)
        if fam == "lm":
            rule = lambda p, s, m: ST.lm_param_spec(  # noqa: E731
                p, s, m, n_experts=cfg.n_experts)
            kv = lambda p, s, m: ST.lm_param_spec(  # noqa: E731
                p, s, m, n_experts=cfg.n_experts, kv_replicate=True)
        else:
            rule = kv = (ST.gnn_param_spec if fam == "gnn"
                         else ST.recsys_param_spec)
        got = _flat_specs(ST.spec_tree(tree, rule, mesh))
        got_kv = _flat_specs(ST.spec_tree(tree, kv, mesh))
        shapes = {p: list(leaf.shape) for p, leaf in leaves_with_paths(tree)}
        assert sorted(got) == sorted(want) == sorted(shapes)
        for p, (shape, spec, spec_kv, z1) in want.items():
            assert shapes[p] == shape, p
            assert got[p] == _dec(spec), (p, got[p], spec)
            assert got_kv[p] == _dec(spec_kv), p
            assert ST.zero1_spec(got[p], tuple(shape), mesh) == _dec(z1), p


def test_unembed_takes_the_embed_branch():
    """``"embed" in path`` is tested first, so ``unembed`` is sharded on
    its rows, as in ``repro``; the ``unembed`` branch is never reached."""
    mesh = _mesh("2x16x16")
    assert ST.lm_param_spec("unembed", (4096, 64000), mesh) == \
        P("model", None)
    assert ST.lm_param_spec("layers/attn/wkv_b", (2, 256, 4096), mesh) == \
        P(None, None, "model")


@pytest.mark.parametrize("mk", list(MESHES))
def test_cache_batch_index_specs_equal_repro(repro_side, mk):
    """``lm_cache_spec`` for every LM cache buffer at several batches,
    ``batch_spec`` at ranks 1-3, ``index_partition_spec`` over the port's
    ``FlatIndex`` and ``PagedIndex`` fields."""
    res = repro_side[0]
    mesh = _mesh(mk)
    for key, (shape, spec) in res["caches"].items():
        if key.split("|")[2] == mk:
            assert ST.lm_cache_spec(key.split("|")[4], tuple(shape), mesh,
                                    int(key.split("|")[3])) == _dec(spec), key
    for nd in (1, 2, 3):
        for b in BATCHES:
            assert ST.batch_spec(mesh, nd, b) == \
                _dec(res["batch"][f"{mk}|{nd}|{b}"]), (nd, b)
    for path, shape in _index_fields():
        assert ST.index_partition_spec(path, tuple(shape), mesh) == \
            _dec(res["index"][f"{mk}|{path}"]), path


# -- shards ----------------------------------------------------------------------

@pytest.mark.parametrize("j", range(len(SHARD_SPECS)))
def test_shard_tensor_equals_addressable_shards(repro_side, j):
    _, out, arrays = repro_side
    mesh = _mesh("2x2")
    spec = P(*SHARD_SPECS[j])
    x = torch.from_numpy(arrays["shard_x"])
    shards = ST.shard_tensor(x, spec, mesh)
    for i, s in enumerate(shards):
        np.testing.assert_array_equal(s.numpy(), out[f"shard{j}_{i}"])
    assert torch.equal(ST.unshard(shards, spec, mesh), x)


def test_shard_tensor_views_and_refusals():
    mesh = _mesh("2x2")
    x = torch.arange(24.0).reshape(4, 6)
    s = ST.shard_tensor(x, P("data", None), mesh)
    assert s[0].data_ptr() == x.data_ptr() and s[1].data_ptr() == x.data_ptr()
    with pytest.raises(ValueError, match="split"):
        ST.shard_tensor(x, P(None, ("data", "model")), mesh)
    with pytest.raises(ValueError, match="not an axis"):
        ST.shard_tensor(x, P("pod"), mesh)
    with pytest.raises(ValueError, match="twice"):
        ST.shard_tensor(x, P("data", "data"), mesh)


# -- the mesh and the collectives -------------------------------------------------

def test_mesh_axes_and_one_axis_compat():
    one = Mesh(["cpu"] * 3)
    assert one.axis_names == ("data",) and one.shape == {"data": 3}
    assert one.size == 3 and one.devices == (torch.device("cpu"),) * 3
    m = _mesh("2x16x16")
    assert list(m.shape.items()) == [("pod", 2), ("data", 16), ("model", 16)]
    assert m.size == 512 and m.coords()[17] == (0, 1, 1)
    assert ST.dp_axes(m) == ("pod", "data") and LM.data_axes(m) == \
        ("pod", "data") and LM.model_axis(m) == "model"
    assert Mesh(["cpu"] * 2) == Mesh(["cpu", "cpu"])
    with pytest.raises(ValueError, match="axis names"):
        Mesh(["cpu"] * 4, ("data", "model"))
    with pytest.raises(ValueError, match="at least one"):
        Mesh([])


def test_query_tier_refuses_other_axes():
    from repro_torch.engine import make_engine
    res = repair_compress(make_lists(np.random.default_rng(3)))
    with pytest.raises(ValueError, match="'data' axis"):
        make_engine("torch", res, device="cpu", mesh=_mesh("2x2"))


def test_launch_meshes_on_the_cpu():
    m = LM.make_host_mesh(2, 4, device="cpu")
    assert m.shape == {"data": 1, "model": 1}
    p = LM.make_production_mesh(device="cpu")
    assert p.shape == {"data": 16, "model": 16} and set(p.devices) == \
        {torch.device("cpu")}
    assert LM.make_production_mesh(multi_pod=True, device="cpu").shape == \
        {"pod": 2, "data": 16, "model": 16}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            LM.make_host_mesh(1, 1)


def test_collectives_in_coordinate_order():
    mesh = _mesh("2x2")
    xs = [torch.tensor([float(i), -float(i)]) for i in range(4)]
    assert [t.tolist() for t in spmd.psum(xs, "model", mesh)] == \
        [[1.0, -1.0]] * 2 + [[5.0, -5.0]] * 2
    assert [t.tolist() for t in spmd.psum(xs, ("data", "model"), mesh)] == \
        [[6.0, -6.0]] * 4
    assert [t.tolist() for t in spmd.pmax(xs, "data", mesh)] == \
        [[2.0, 0.0], [3.0, -1.0]] * 2
    assert [t.tolist() for t in spmd.psum(xs, (), mesh)] == \
        [x.tolist() for x in xs]
    moved = spmd.ppermute(xs, "data", [(0, 1)], mesh)
    assert [t.tolist() for t in moved] == [[0.0, 0.0], [0.0, 0.0],
                                           [0.0, 0.0], [1.0, -1.0]]
    assert [spmd.axis_index(mesh, "model", i) for i in range(4)] == \
        [0, 1, 0, 1]
    # a bf16 sum runs in coordinate order: ((a + b) + c), rounded each step
    m3 = Mesh(["cpu"] * 3)
    a, b, c = (torch.tensor([v], dtype=torch.bfloat16)
               for v in (1.0, 2.0 ** -8, 2.0 ** -8))
    assert spmd.psum([a, b, c], "data", m3)[0].item() == 1.0


# -- the compressed gradient psum ---------------------------------------------------

@pytest.mark.parametrize("n", [2, 3])
def test_compressed_psum_bit_exact(repro_side, n):
    _, out, arrays = repro_side
    mesh = Mesh(["cpu"] * n)
    names = ("f32_w", "bf16_g", "f32_s")

    def leaf(t, k, i):
        a = torch.from_numpy(np.asarray(arrays[f"psum{n}_{t}_{k}"][i]))
        return a.to(torch.bfloat16) if k.startswith("bf16") else a

    errs = [{k: torch.zeros(arrays[f"psum{n}_0_{k}"].shape[1:])
             for k in names} for _ in range(n)]
    for t in range(PSUM_STEPS):
        grads = [{k: leaf(t, k, i) for k in names} for i in range(n)]
        tgts = [{k: g[k].float() + e[k] for k in names}
                for g, e in zip(grads, errs)]
        red, errs = compressed_psum_with_feedback(grads, errs, "data", mesh)
        for k in names:
            for i in range(n):
                np.testing.assert_array_equal(
                    red[i][k].numpy(), out[f"psum{n}_{t}_out_{k}"][i])
                np.testing.assert_array_equal(
                    errs[i][k].numpy(), out[f"psum{n}_{t}_err_{k}"][i])
            # the carried residuals close the sum, within float32 rounding
            # of the terms
            lhs = red[0][k] + sum(e[k] for e in errs)
            rhs = sum(tg[k] for tg in tgts)
            mag = red[0][k].abs() + sum(e[k].abs() + tg[k].abs()
                                        for e, tg in zip(errs, tgts))
            assert bool(((lhs - rhs).abs() <= 8 * 2.0 ** -24 * mag).all())


def test_opt_state_shape_is_meta():
    from repro_torch.train.optimizer import init_opt_state_shape
    model = TT.init_params_shape(get_arch("yi-6b").config)
    st = init_opt_state_shape(model)
    wq = st.mu["layers"]["attn"]["wq"]
    assert wq.device.type == "meta" and wq.dtype == torch.float32
    assert tuple(wq.shape) == (32, 4096, 4096)
    assert st.count.dtype == torch.int32 and st.count.device.type == "meta"
    assert sum(t.numel() for _, t in leaves_with_paths(st.nu)) == \
        get_arch("yi-6b").config.param_count()


# -- the mesh-wired LM ----------------------------------------------------------------

@pytest.mark.parametrize("name", LM_MESHED)
def test_meshed_lm_forward_equals_repro(repro_side, name):
    _, out, arrays = repro_side
    base_j = get_arch_jax(name).smoke_config
    params = TJ.init_params(jax.random.key(0), base_j)
    cfg = dataclasses.replace(get_arch(name).smoke_config, mesh=_mesh("2x2"),
                              dp_spec="data", tp_axis="model",
                              sp_axis="model")
    model = lm_params_from_numpy(jax.tree.map(np.asarray, params), cfg, "cpu")
    logits, aux = model(torch.from_numpy(arrays[f"lm_{name}"]))
    np.testing.assert_allclose(logits.numpy(), out[f"lm_{name}_logits"],
                               **TOL)
    np.testing.assert_allclose(aux.numpy(), out[f"lm_{name}_aux"], **TOL)
