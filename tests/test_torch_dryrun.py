"""The port's dry run against the JAX package: the lowering specs, the
roofline's parser and ring formulas, FLOPs against closed forms, the
rules' collectives against hand counts, elastic restore, and the training
launcher's production mode.

The JAX side runs once, in a subprocess with ``JAX_PLATFORMS=cpu`` and
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` (this process keeps
its one JAX device).  Its meshes have ``Auto`` axes: ``jax.make_mesh``
now gives ``Explicit`` ones, on which ``repro``'s LM ``train_4k`` and
``prefill_32k`` cells do not lower (``transformer._sp_constrain``'s
``with_sharding_constraint`` may name only ``Auto`` axes).  It reports:

* ``build_lowering_spec`` of all 43 cells on ``AbstractMesh`` (16, 16)
  and (2, 16, 16): each argument's path, shape and dtype, each in and out
  spec, ``donate_argnums``, and the per-device argument bytes (the sum of
  ``NamedSharding.shard_shape`` bytes);
* each cell compiled on a (2, 4) mesh of 8 devices (the LM cells at 2
  layers, unrolled): ``memory_analysis().argument_size_in_bytes``, the
  arguments ``jit`` prunes because the step never reads them
  (``input_shardings`` None: bst ``retrieval_cand``'s MLP head, the ir
  engine's ``lengths`` and ``sym_len``), the per-partition
  ``cost_analysis()`` FLOPs and bytes accessed, and the program's
  collective lines with ``repro``'s ``parse_collectives`` of them;
* each cell compiled on a (1, 1) mesh the same way: its
  ``cost_analysis()`` FLOPs and bytes accessed (the whole step's);
* ``model_flops_for`` of every cell;
* ``parse_collectives`` on ``tests/test_hlo_analysis.py``'s five HLO
  strings and on generated lines of every op kind, group form and dtype;
* ``CheckpointManager.restore(shardings=)`` of a checkpoint the port
  wrote, onto (2, 2) and (1, 4) meshes of 4 devices: every addressable
  shard, by its device's coordinate.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeSpec
from repro_torch.distributed import Mesh, P, shard_tensor
from repro_torch.distributed.sharding import lm_param_spec, spec_tree, \
    zero1_spec
from repro_torch.launch import dryrun as D
from repro_torch.launch import hlo_analysis as H
from repro_torch.launch import mesh as LM
from repro_torch.launch import specs as SP
from repro_torch.launch import train as launch_train
from repro_torch.models.transformer import init_params
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import OptState, init_opt_state
from repro_torch.train.tree import leaves_with_paths

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
RESTORE_MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
XLA_FLOPS_CELLS = [["yi-6b", "train_4k"], ["granite-moe-3b-a800m",
                                           "train_4k"],
                   ["yi-6b", "prefill_32k"]]
PRUNED = {("bst", "retrieval_cand"): {"0/mlp_b/0", "0/mlp_b/1", "0/mlp_b/2",
                                      "0/mlp_b/3", "0/mlp_w/0", "0/mlp_w/1",
                                      "0/mlp_w/2", "0/mlp_w/3"},
          ("repair-ir", "serve_members"): {"0/lengths", "0/sym_len"},
          ("repair-ir", "serve_pairs"): {"0/lengths", "0/sym_len"}}

_REPRO = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import (AbstractMesh, AxisType, Mesh, NamedSharding,
                          PartitionSpec as P)
from repro.configs import get_arch
from repro.launch import specs as SP
from repro.launch.dryrun import model_flops_for
from repro.launch.hlo_analysis import parse_collectives
from repro.models import transformer as T
from repro.train.checkpoint import CheckpointManager
from repro.train.optimizer import init_opt_state_shape

inp = json.load(open(sys.argv[1]))
res, out = {}, {}
enc = lambda s: [list(e) if isinstance(e, tuple) else e for e in s]
is_ns = lambda x: isinstance(x, NamedSharding)
key = lambda kp: "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                          for k in kp)

def flat(tree, is_leaf=None):
    fl, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return [(key(kp), v) for kp, v in fl]

def shard_sum(args, shardings):
    sh = dict(flat(shardings, is_ns))
    return sum(int(np.prod(sh[p].shard_shape(a.shape))) * a.dtype.itemsize
               for p, a in flat(args))

cells = SP.all_cells()
for mk, (shape, names) in inp["meshes"].items():
    am = AbstractMesh(tuple(shape), tuple(names),
                      axis_types=(AxisType.Auto,) * len(names))
    for a, s in cells:
        sp = SP.build_lowering_spec(a, s, am)
        res[f"spec|{mk}|{a}|{s}"] = {
            "args": {p: [list(v.shape), str(v.dtype)]
                     for p, v in flat(sp.args)},
            "in": {p: enc(v.spec) for p, v in flat(sp.in_shardings, is_ns)},
            "out": {p: enc(v.spec) for p, v in flat(sp.out_shardings, is_ns)},
            "donate": list(sp.donate_argnums),
            "bytes": shard_sum(sp.args, sp.in_shardings)}

def compiled(a, s, mesh):
    sp = SP.build_lowering_spec(a, s, mesh, unroll=True, n_layers_override=2)
    with jax.set_mesh(mesh):
        c = jax.jit(sp.fn, in_shardings=sp.in_shardings,
                    out_shardings=sp.out_shardings,
                    donate_argnums=sp.donate_argnums).lower(*sp.args).compile()
    ca = c.cost_analysis()
    ca = ca[0] if isinstance(ca, (list, tuple)) else ca
    return sp, c, {"flops": float(ca.get("flops", 0.0)),
                   "bytes": float(ca.get("bytes accessed", 0.0))}

mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
one = jax.make_mesh((1, 1), ("data", "model"),
                    axis_types=(AxisType.Auto,) * 2)
for a, s in cells:
    sp, c, cost = compiled(a, s, mesh)
    kept = dict(flat(c.input_shardings[0], lambda x: x is None or is_ns(x)))
    text = c.as_text()
    st = parse_collectives(text, 8)
    res[f"xla|{a}|{s}"] = {
        "bytes": shard_sum(sp.args, sp.in_shardings),
        "xla": int(c.memory_analysis().argument_size_in_bytes),
        "pruned": sorted(p for p, v in kept.items() if v is None),
        "cost": cost,
        "lines": [ln for ln in text.splitlines()
                  if any(k in ln for k in inp["collectives"])],
        "parse": [st.wire_bytes, st.op_counts, st.op_bytes]}
    res[f"xla11|{a}|{s}"] = compiled(a, s, one)[2]
res["model_flops"] = {f"{a}|{s}": model_flops_for(a, s) for a, s in cells}
res["parse"] = []
for text, n in inp["hlo"]:
    st = parse_collectives(text, n)
    res["parse"].append([st.wire_bytes, st.op_counts, st.op_bytes])

# elastic restore of the port's checkpoint
cfg = get_arch("yi-6b").smoke_config
pshape = T.init_params_shape(cfg)
target = {"params": pshape, "opt": init_opt_state_shape(pshape),
          "step": jax.ShapeDtypeStruct((), jnp.int32)}
devs = np.array(jax.devices()[:4])
cm = CheckpointManager(inp["ckpt"])
for mk, grid in inp["restore_meshes"].items():
    m = Mesh(devs.reshape(grid), ("data", "model"))
    specs = inp["restore_specs"][mk]
    shardings = jax.tree_util.tree_map_with_path(
        lambda kp, _: NamedSharding(m, P(*[tuple(e) if isinstance(e, list)
                                          else e for e in specs[key(kp)]])),
        target)
    state, _ = cm.restore(cm.latest(), target, shardings=shardings)
    for p, arr in flat(state):
        for s in arr.addressable_shards:
            (i, k), = np.argwhere(m.devices == s.device)
            v = np.asarray(s.data)
            out[f"{mk}|{p}|{i * grid[1] + k}"] = (
                v.astype(np.float32) if v.dtype == jnp.bfloat16 else v)

json.dump(res, open(sys.argv[2], "w"))
np.savez(sys.argv[3], **out)
"""

HLO_TESTS = [
    ('%ar = f32[1024,1024]{1,0} all-reduce(f32[1024,1024] %p), '
     'replica_groups={{0,1,2,3}}, to_apply=%add\n', 4),
    ('%ag = bf16[64,256]{1,0} all-gather(bf16[4,256] %p), '
     'replica_groups=[1,16]<=[16], dimensions={0}\n'
     '%rs = bf16[4,256]{1,0} reduce-scatter(bf16[64,256] %q), '
     'replica_groups=[1,16]<=[16], dimensions={0}\n', 16),
    ('%cp = f32[128]{0} collective-permute(f32[128] %p), '
     'source_target_pairs={{0,1},{1,0}}\n'
     '%s = f32[128]{0} all-reduce-start(f32[128] %p), '
     'replica_groups={{0,1}}\n'
     '%d = f32[128]{0} all-reduce-done(%s)\n', 2),
    ('%t = (f32[64]{0}, bf16[32]{0}) all-gather(f32[4] %a, '
     'bf16[2] %b), replica_groups={{0,1,2,3,4,5,6,7,'
     '8,9,10,11,12,13,14,15}}, dimensions={0}\n', 16),
    ('%ar = f32[128]{0} all-reduce(f32[128] %p), '
     'replica_groups={{0}}, to_apply=%add\n', 256),
]
GROUPS = {"list": ("replica_groups={{0,1,2,3,4}}", 5),
          "iota": ("replica_groups=[4,6]<=[24]", 6),
          "none": ("channel_id=1", 12)}


def _generated() -> list[tuple[str, int, tuple]]:
    """One HLO line per op kind × group form × dtype (plus a ``-start``
    form and a tuple result), with what ``add_collective`` is given for
    it: (text, num_devices, (op, out_bytes, k) or None)."""
    out = []
    dtypes = list(H._DTYPE_BYTES) + ["token"]
    for op in H.COLLECTIVES:
        for gname, (groups, k) in GROUPS.items():
            for j, dt in enumerate(dtypes):
                dims = f"{3 + j},{7 + k}"
                suffix = "-start" if j % 3 == 0 else ""
                text = (f"%x = {dt}[{dims}]{{1,0}} {op}{suffix}({dt}[1,1] "
                        f"%p), {groups}\n")
                nbytes = H._shape_bytes(dt, dims)
                out.append((text, 12, (op, nbytes, k)))
            text = (f"%t = (f32[8]{{0}}, bf16[6,2]{{1,0}}) {op}(f32[1] %a, "
                    f"bf16[1] %b), {groups}\n")
            out.append((text, 12, (op, 8 * 4 + 12 * 2, k)))
    return out


def _restore_state():
    """The checkpointed state: the yi-6b smoke model, its optimizer state
    with moments drawn from a seed, and a step counter."""
    cfg = get_arch("yi-6b").smoke_config
    model = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    opt = init_opt_state(model)
    g = torch.Generator().manual_seed(4)
    for _, leaf in leaves_with_paths((opt.mu, opt.nu)):
        leaf.copy_(torch.randn(leaf.shape, generator=g))
    return {"params": model, "opt": opt,
            "step": torch.tensor(7, dtype=torch.int32)}


def _restore_specs(state, grid) -> dict:
    """``{path: P}``: the LM rule for the parameters, ZeRO-1 for the
    moments, replicated scalars."""
    mesh = Mesh(np.full(grid, "cpu", dtype=object), ("data", "model"))
    cfg = state["params"].cfg

    def rule(p, s, m):
        return lm_param_spec(p, s, m, n_experts=cfg.n_experts)

    def moment(p, s, m):
        return zero1_spec(rule(p, s, m), s, m)

    tree = {"params": spec_tree(state["params"], rule, mesh),
            "opt": OptState(mu=spec_tree(state["params"], moment, mesh),
                            nu=spec_tree(state["params"], moment, mesh),
                            count=P()),
            "step": P()}
    return mesh, SP.spec_leaves(tree), tree


@pytest.fixture(scope="module")
def repro_side(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    state = _restore_state()
    CheckpointManager(str(tmp / "ckpt")).save(5, state)
    specs = {}
    for mk, grid in RESTORE_MESHES.items():
        specs[mk] = {p: [list(e) if isinstance(e, tuple) else e for e in s]
                     for p, s in _restore_specs(state, grid)[1].items()}
    hlo = [[t, n] for t, n in HLO_TESTS] + [[t, n] for t, n, _ in
                                            _generated()]
    inp = dict(meshes={k: [list(s), list(n)] for k, (s, n) in MESHES.items()},
               hlo=hlo, ckpt=str(tmp / "ckpt"), collectives=H.COLLECTIVES,
               restore_meshes={k: list(g) for k, g in RESTORE_MESHES.items()},
               restore_specs=specs)
    (tmp / "in.json").write_text(json.dumps(inp))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=f"{ROOT / 'src'}")
    files = [str(tmp / f) for f in ("in.json", "out.json", "out.npz")]
    r = subprocess.run([sys.executable, "-c", _REPRO, *files],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    return (json.loads((tmp / "out.json").read_text()),
            dict(np.load(tmp / "out.npz")), state)


def _meta_mesh(key: str) -> Mesh:
    return LM.make_production_mesh(multi_pod=key == "2x16x16",
                                   device="meta")


def _dec(spec) -> P:
    return P(*[tuple(e) if isinstance(e, list) else e for e in spec])


def _dtype(t) -> str:
    return str(t.dtype).split(".")[-1]


# -- the specs ------------------------------------------------------------------

@pytest.mark.parametrize("mk", list(MESHES))
@pytest.mark.parametrize("cell", [f"{a}|{s}" for a, s in SP.all_cells()])
def test_specs_equal_repro(repro_side, cell, mk):
    """Every cell on the (16, 16) and (2, 16, 16) meshes: the arguments
    leaf by leaf (path, shape, dtype), every in and out spec, the donated
    arguments, and the per-device argument bytes equal ``repro``'s."""
    want = repro_side[0][f"spec|{mk}|{cell}"]
    arch, shape = cell.split("|")
    mesh = _meta_mesh(mk)
    spec = SP.build_lowering_spec(arch, shape, mesh)
    args = {p: [list(leaf.shape), _dtype(leaf)]
            for p, leaf in leaves_with_paths(spec.args)}
    assert args == want["args"]
    ins = SP.spec_leaves(spec.in_shardings)
    assert sorted(ins) == sorted(want["in"])
    for p, s in want["in"].items():
        assert ins[p] == _dec(s), (p, ins[p], s)
    if get_arch(arch).family == "lm":
        out = D._outputs(spec)
    else:
        out = D.trace(spec).out
    outs = SP.spec_leaves(spec.out_shardings)
    assert sorted(outs) == sorted(want["out"])
    assert sorted(p for p, _ in leaves_with_paths(out)) == sorted(outs)
    for p, s in want["out"].items():
        assert outs[p] == _dec(s), (p, outs[p], s)
    assert list(spec.donate_argnums) == want["donate"]
    assert D.tree_shard_bytes(spec.args, spec.in_shardings, mesh) == \
        want["bytes"]


def test_lm_outputs_are_the_traced_ones():
    """An LM cell's outputs, taken from its spec without a trace, have
    the paths, shapes and dtypes of the traced step's outputs."""
    for name in ("yi-6b", "minicpm3-4b", "granite-moe-3b-a800m"):
        arch = _smoke(name)
        mesh = Mesh(np.full((2, 2), "meta", dtype=object),
                    ("data", "model"))
        for sh in SMOKE_SHAPES:
            spec = _smoke_spec(arch, sh, mesh)
            got = {p: (tuple(t.shape), t.dtype) for p, t in
                   leaves_with_paths(D._outputs(spec))}
            traced = {p: (tuple(t.shape), t.dtype) for p, t in
                      leaves_with_paths(D.trace(spec).out)}
            assert got == traced, (name, sh.name)


@pytest.mark.parametrize("cell", [f"{a}|{s}" for a, s in SP.all_cells()])
def test_argument_bytes_equal_xla(repro_side, cell):
    """Compiled on (2, 4), XLA's argument bytes equal the port's (and
    ``repro``'s shard sum) less the arguments ``jit`` prunes because the
    step never reads them: none in 40 cells; bst ``retrieval_cand``'s MLP
    head (925,700 bytes) and the ir engine's ``lengths`` and ``sym_len``
    (20,971,520 bytes) in the other three."""
    want = repro_side[0][f"xla|{cell}"]
    arch, shape = cell.split("|")
    mesh = Mesh(np.full((2, 4), "meta", dtype=object), ("data", "model"))
    spec = SP.build_lowering_spec(arch, shape, mesh, n_layers_override=2
                                  if get_arch(arch).family == "lm" else None)
    got = D.tree_shard_bytes(spec.args, spec.in_shardings, mesh)
    assert got == want["bytes"]
    assert set(want["pruned"]) == PRUNED.get((arch, shape), set())
    sp = SP.spec_leaves(spec.in_shardings)
    pruned = sum(D.shard_bytes(leaf, sp[p], mesh)
                 for p, leaf in leaves_with_paths(spec.args)
                 if p in want["pruned"])
    assert got - pruned == want["xla"]
    assert pruned == {("bst", "retrieval_cand"): 925_700,
                      ("repair-ir", "serve_members"): 20_971_520,
                      ("repair-ir", "serve_pairs"): 20_971_520}.get(
        (arch, shape), 0)


@pytest.mark.parametrize("cell", ["|".join(c) for c in XLA_FLOPS_CELLS])
def test_traced_flops_beside_xla(repro_side, cell):
    """The meta trace's FLOPs against XLA's ``cost_analysis`` of the same
    cell on (1, 1) at full width, 2 layers, unrolled.  They differ, and
    should: XLA counts a while body once, and ``repro``'s flash attention
    loops over its kv chunks even unrolled, so its S² attention is counted
    once a layer, not once a chunk (the port's chunk loop is Python, every
    chunk traced).  Taking (1 - 1/chunks) of the attention's products out
    of the port's count (forward, recompute and a backward of twice the
    forward in training) leaves it within 3% of XLA's: ratios 1.09 (yi-6b
    ``train_4k``, 4 chunks of 1024), 1.15 (granite ``train_4k``) and 2.45
    (yi-6b ``prefill_32k``, 32 chunks)."""
    arch, shape = cell.split("|")
    xla = repro_side[0][f"xla11|{cell}"]["flops"]
    mesh = Mesh(np.full((1, 1), "meta", dtype=object), ("data", "model"))
    got = D.count_spec(SP.build_lowering_spec(arch, shape, mesh,
                                              n_layers_override=2)).flops
    cfg = dataclasses.replace(get_arch(arch).config, n_layers=2)
    sh = get_arch(arch).shape(shape)
    B, S = sh.params["batch"], sh.params["seq"]
    head = cfg.head_dim
    attn = cfg.n_layers * 2 * 2 * B * cfg.n_heads * S * S * head
    passes = 4 if sh.kind == "train" else 1
    chunks = S // cfg.kv_chunk
    once_a_layer = got - passes * attn * (1 - 1 / chunks)
    ratio = {"yi-6b|train_4k": 1.09, "granite-moe-3b-a800m|train_4k": 1.15,
             "yi-6b|prefill_32k": 2.45}[cell]
    assert round(got / xla, 2) == ratio, got / xla
    assert abs(once_a_layer / xla - 1) < 0.03, once_a_layer / xla


# The port's per-device counts beside XLA's, cell by cell.  Five ratios,
# port / XLA: Fg the whole step's FLOPs (both on a (1, 1) mesh); Fd how
# each splits them over a (2, 4) mesh (the port's whole / per-device over
# XLA's whole / per-partition); Bg and Bd the same for the bytes; W the
# per-device collective wire bytes on (2, 4).  Fg x Fd ... is the
# per-device ratio.  The causes, by code:
CAUSES = {
    "E": "XLA's flops also count elementwise and reduction ops (one a "
         "result element, exp and rsqrt included); the port counts "
         "products, which the tensor cores' peak divides: a softmax over "
         "a 32k cache per head (decode), the retrieval encoders, the "
         "engine's compares (repair-ir: no products at all, Fg 0)",
    "L": "XLA counts a while body once: repro's flash attention loops over "
         "its kv chunks even unrolled, so its S^2 products count once a "
         "layer (test_traced_flops_beside_xla); the port traces every "
         "chunk: FLOPs x1.06-1.17 in training, x2.0-4.4 and bytes x17-39 "
         "in prefill (32 chunks)",
    "U": "the port counts every op's operands, unfused; XLA's bytes are "
         "after fusion (training x2.2-2.4)",
    "F": "XLA:CPU computes bf16 in float32, so its bytes of a bf16 "
         "activation or cache are twice the port's (decode's cache reads)",
    "=": "the same split (Fd) or the same collectives, byte for byte (W "
         "1.0: the recsys lookups' all-reduces over model, bst's "
         "row-parallel MLP products)",
    "S": "XLA splits more than the products' split: it also cuts part of "
         "the step's elementwise work over model (recsys training, the "
         "update of the model-cut tables; bst's encoder)",
    "R": "XLA splits less: it all-reduces the GNN's aggregated nodes and "
         "runs the dense layers on every device; the rules keep the edges "
         "and their products cut over data.  Retrieval: the port cuts the "
         "candidates' scoring over model and counts products only; XLA's "
         "replicated elementwise encoder work dilutes its split",
    "D": "decode: XLA re-cuts each layer's cache between sequence and heads "
         "by all-to-alls (3.2 GB a step for yi-6b on (2, 4)) and leaves "
         "part of the attention replicated (split 3.6-4.8 of 8); the rules "
         "keep the cache cut over sequence and combine partial softmaxes",
    "T": "training: XLA gathers whole weights over model in float32 (an "
         "FSDP-like choice) where the rules count Megatron's activation "
         "all-reduces, and all-reduces the gradients (XLA:CPU forms no "
         "reduce-scatter) where ZeRO-1 reduce-scatters them",
    "P": "prefill: XLA gathers weights over model (float32); the rules "
         "count Megatron's all-reduces and the cache's re-cut",
    "K": "XLA's combiner merges collectives of one kind into one op of a "
         "tuple (deepfm's two tables' lookups, bst's two, the GNN's "
         "gradients); the port counts one a leaf or a lookup",
    "C": "XLA also re-cuts ids and rows by collective-permutes and "
         "all-gathers that the rules do not make (recsys training and "
         "retrieval); the GNN's second layer reads replicated nodes in "
         "the rules, where XLA re-cuts them and all-reduces the gathered "
         "rows",
    "?": "not analysed further",
}
# cell: (Fg, Fd, Bg, Bd, W, (the port's collectives, XLA's), the causes
# of Fg Fd Bg Bd W and of the counts); None: 0 on both sides.  The
# recsys serving cells' wire bytes are XLA's exactly.
BESIDE_XLA = {
    "bert4rec|train_batch": (
        0.945, 0.897, 0.923, 1.03, 0.948, (33, 44), "ES??CC"),
    "bert4rec|serve_p99": (0.96, 1, 0.872, 0.988, 1.0, (1, 1), "E=??=="),
    "bert4rec|serve_bulk": (0.96, 1, 0.867, 1.01, 1.0, (1, 1), "E=??=="),
    "bert4rec|retrieval_cand": (
        0.722, 1.41, 1.94, 3.48, 0.372, (2, 4), "ERURCC"),
    "bst|train_batch": (0.951, 1.23, 1.18, 2.04, 0.684, (37, 57), "ER?RCC"),
    "bst|serve_p99": (0.966, 0.938, 1.06, 0.692, 1.0, (4, 3), "ES?S=K"),
    "bst|serve_bulk": (0.966, 0.938, 1.17, 1.02, 1.0, (4, 3), "ES?S=K"),
    "bst|retrieval_cand": (0.629, 2.35, 1.98, 3.58, 0.369, (2, 4), "ERURCC"),
    "deepfm|train_batch": (0.979, 0.827, 2.36, 1.12, 1.21, (21, 24), "ESU?CC"),
    "deepfm|serve_p99": (0.993, 1, 1.01, 0.52, 1.0, (2, 1), "E=??=K"),
    "deepfm|serve_bulk": (0.993, 1, 1.19, 1.07, 1.0, (2, 1), "E=U?=K"),
    "deepfm|retrieval_cand": (0.993, 1, 1.2, 1.23, 0.851, (2, 5), "E=U?CC"),
    "gcn-cora|full_graph_sm": (
        0.886, 1.35, 1.58, 2.62, 0.848, (7, 8), "ERURCC"),
    "gcn-cora|minibatch_lg": (0.863, 1, 1.02, 0.999, 0.9999, (4, 1), "E====K"),
    "gcn-cora|ogb_products": (0.58, 1.18, 1.9, 2.44, 0.833, (7, 8), "ERURCC"),
    "gcn-cora|molecule": (0.885, 1.2, 1.48, 1.9, 0.671, (7, 8), "ERURCC"),
    "granite-moe-3b-a800m|train_4k": (
        1.15, 1, 2.26, 1.19, 0.366, (55, 78), "L=U?TT"),
    "granite-moe-3b-a800m|prefill_32k": (
        3.96, 1.01, 25.6, 1.32, 0.511, (14, 20), "L=L?PP"),
    "granite-moe-3b-a800m|decode_32k": (
        0.276, 2.24, 0.626, 1.73, 0.00686, (18, 26), "EDFDDD"),
    "granite-moe-3b-a800m|long_500k": (
        0.29, 1.03, 0.663, 0.749, 0.0522, (12, 24), "E=F?DD"),
    "minicpm3-4b|train_4k": (1.17, 1, 2.33, 1.07, 0.532, (47, 82), "L=U?TT"),
    "minicpm3-4b|prefill_32k": (4.45, 1, 39, 1.16, 0.807, (8, 24), "L=L?PP"),
    "minicpm3-4b|decode_32k": (0.983, 1, 1.21, 1, 0.707, (12, 66), "E=U=DD"),
    "minicpm3-4b|long_500k": (
        0.924, 0.977, 0.487, 0.396, 0.0688, (12, 56), "E=F?DD"),
    "phi3.5-moe-42b-a6.6b|train_4k": (
        1.08, 1, 2.29, 1.26, 0.367, (55, 78), "L=U?TT"),
    "phi3.5-moe-42b-a6.6b|prefill_32k": (
        2.08, 1, 24.9, 1.38, 0.507, (14, 20), "L=L?PP"),
    "phi3.5-moe-42b-a6.6b|decode_32k": (
        0.389, 2.04, 0.521, 1.54, 0.0032, (18, 26), "EDFDDD"),
    "phi3.5-moe-42b-a6.6b|long_500k": (
        0.33, 1.03, 0.767, 0.931, 0.025, (12, 24), "E=F?DD"),
    "qwen3-32b|train_4k": (1.06, 1, 2.21, 1.09, 0.454, (45, 75), "L=U?TT"),
    "qwen3-32b|prefill_32k": (2.05, 1, 33.3, 1.18, 0.723, (8, 22), "L=L?PP"),
    "qwen3-32b|decode_32k": (
        0.613, 1.66, 0.304, 1.32, 0.011, (12, 26), "EDFDDD"),
    "qwen3-32b|long_500k": (
        0.336, 0.929, 0.209, 0.333, 0.0817, (12, 24), "E=F?DD"),
    "repair-ir|serve_members": (0, None, 0.528, 1.26, None, (0, 0), "E-??-="),
    "repair-ir|serve_pairs": (0, None, 0.401, 1.02, None, (0, 0), "E-??-="),
    "repair-ir|decode_bulk": (0, None, 0.923, 1.0, None, (0, 0), "E-?=-="),
    "sasrec|train_batch": (
        0.911, 0.867, 0.843, 1.03, 0.888, (33, 44), "ES??CC"),
    "sasrec|serve_p99": (0.954, 1, 0.985, 0.904, 1.0, (1, 1), "E=??=="),
    "sasrec|serve_bulk": (0.954, 1, 0.981, 1.01, 1.0, (1, 1), "E=??=="),
    "sasrec|retrieval_cand": (
        0.655, 2.05, 1.97, 3.55, 0.371, (2, 4), "ERURCC"),
    "yi-6b|train_4k": (1.09, 1, 2.18, 1.08, 0.759, (41, 73), "L=U?TT"),
    "yi-6b|prefill_32k": (2.45, 1, 32.7, 1.18, 1.18, (8, 22), "L=L?PP"),
    "yi-6b|decode_32k": (0.563, 1.75, 0.304, 1.33, 0.01, (12, 26), "EDFDDD"),
    "yi-6b|long_500k": (
        0.337, 0.964, 0.208, 0.308, 0.0746, (12, 24), "E=F?DD"),
}


def _cell_counts(arch: str, shape: str, grid) -> "D.Counts":
    mesh = Mesh(np.full(grid, "meta", dtype=object), ("data", "model"))
    lm = get_arch(arch).family == "lm"
    return D.cell_counts(arch, shape, SP.build_lowering_spec(
        arch, shape, mesh, n_layers_override=2 if lm else None))


@pytest.mark.parametrize("cell", [f"{a}|{s}" for a, s in SP.all_cells()])
def test_counts_beside_xla(repro_side, cell):
    """The port's per-device FLOPs, bytes and collectives on a (2, 4) mesh
    of meta entries beside XLA's per-partition counts of ``repro``'s
    compiled cell, and the whole step's on (1, 1): each ratio pinned
    (within 1%), and both counts of collectives, with their causes
    (:data:`CAUSES`).  The port's parser reads
    XLA's program as ``repro``'s does; where the collectives are the same,
    their bytes are equal."""
    arch, shape = cell.split("|")
    x24 = repro_side[0][f"xla|{cell}"]
    x11 = repro_side[0][f"xla11|{cell}"]
    parsed = H.parse_collectives("\n".join(x24["lines"]), 8)
    assert [parsed.wire_bytes, parsed.op_counts, parsed.op_bytes] == \
        x24["parse"]
    p11, p24 = (_cell_counts(arch, shape, g) for g in ((1, 1), (2, 4)))
    xf, xb = x24["cost"]["flops"], x24["cost"]["bytes"]
    got = (p11.flops / x11["flops"],
           p11.flops / p24.flops / (x11["flops"] / xf) if p24.flops
           else None,
           p11.hbm_bytes / x11["bytes"],
           p11.hbm_bytes / p24.hbm_bytes / (x11["bytes"] / xb),
           p24.collectives.wire_bytes / parsed.wire_bytes
           if parsed.wire_bytes else None)
    want = BESIDE_XLA[cell]
    assert all(c in CAUSES or c == "-" for c in want[6])
    for name, g, w in zip(("Fg", "Fd", "Bg", "Bd", "W"), got, want):
        if w is None:
            assert g is None, name
        else:
            assert g == pytest.approx(w, rel=0.01, abs=1e-9), (name, g, w)
    assert (sum(p24.collectives.op_counts.values()),
            sum(parsed.op_counts.values())) == want[5]
    if want[4] is None:
        assert p24.collectives.wire_bytes == 0
    if want[4] == 1.0:
        assert p24.collectives.wire_bytes == parsed.wire_bytes
        assert p24.collectives.op_bytes == parsed.op_bytes


def test_model_flops_equal_repro(repro_side):
    want = repro_side[0]["model_flops"]
    for a, s in SP.all_cells():
        assert D.model_flops_for(a, s) == want[f"{a}|{s}"], (a, s)


def test_ir_shift_is_logical():
    """``lax.shift_right_logical`` on int32: the sign bit shifts in as 0,
    and a shift of 32 or more gives 0 (torch's ``>>`` is arithmetic)."""
    x = torch.tensor([-1, -8, 5, 2**31 - 1, -2**31], dtype=torch.int32)
    k = torch.tensor([1, 3, 0, 40, 31], dtype=torch.int32)
    want = (x.numpy().view(np.uint32).astype(np.uint64)
            >> np.minimum(k.numpy(), 63).astype(np.uint64))
    want = np.where(k.numpy() >= 32, 0, want).astype(np.uint32).view(np.int32)
    assert SP._shift_right_logical(x, k).tolist() == want.tolist()
    assert (x >> k).tolist() != want.tolist()


# -- the parser and the ring formulas -----------------------------------------

def test_parse_collectives_equal_repro(repro_side):
    got = [[t, n] for t, n in HLO_TESTS] + [[t, n] for t, n, _ in
                                            _generated()]
    for (text, n), (wire, counts, obytes) in zip(got, repro_side[0]["parse"]):
        st = H.parse_collectives(text, n)
        assert st.wire_bytes == wire, text
        assert st.op_counts == counts, text
        assert st.op_bytes == obytes, text


@pytest.mark.parametrize("op", H.COLLECTIVES)
def test_add_collective_agrees_with_the_parser(op):
    """``add_collective`` of a line's result bytes and group size equals
    the parser on that line, for every group form and dtype."""
    for text, n, (kind, nbytes, k) in _generated():
        if kind != op:
            continue
        st = H.CollectiveStats()
        st.add_collective(kind, nbytes, k)
        parsed = H.parse_collectives(text, n)
        assert (st.wire_bytes, st.op_counts, st.op_bytes) == (
            parsed.wire_bytes, parsed.op_counts, parsed.op_bytes), text


def test_roofline_from_counts():
    st = H.CollectiveStats()
    st.add_collective("all-reduce", 450e9 / 2, 2)
    t = H.roofline_from_counts(989e12, 3.35e12 * 2, st, 4, model_flops=2e15)
    assert (t.compute_s, t.memory_s, t.collective_s) == (1.0, 2.0, 0.5)
    assert t.bottleneck == "memory"
    assert t.useful_ratio == 2e15 / (989e12 * 4)
    assert set(t.summary()) == {"flops", "hbm_bytes", "wire_bytes",
                                "compute_s", "memory_s", "collective_s",
                                "bottleneck", "model_flops", "useful_ratio",
                                "collectives"}


# -- FLOPs against closed forms --------------------------------------------------

SMOKE_SHAPES = (
    ShapeSpec("train_4k", "train", {"seq": 64, "batch": 8}),
    ShapeSpec("prefill_32k", "prefill", {"seq": 64, "batch": 4}),
    ShapeSpec("decode_32k", "decode", {"seq": 64, "batch": 8}),
    ShapeSpec("long_500k", "long_decode", {"seq": 4096, "batch": 1,
                                           "window": 32}))
LM_SMOKE = ("yi-6b", "qwen3-32b", "minicpm3-4b", "granite-moe-3b-a800m",
            "phi3.5-moe-42b-a6.6b")


def _smoke(name: str):
    """The arch with its smoke config as its config and small shapes."""
    a = get_arch(name)
    if a.family != "lm":
        return a
    return dataclasses.replace(a, config=a.smoke_config, shapes=SMOKE_SHAPES)


def _smoke_spec(arch, shape, mesh, layers=None):
    build = {"train": SP.lm_train_spec, "prefill": SP.lm_prefill_spec}.get(
        shape.kind, SP.lm_decode_spec)
    return build(arch, shape, mesh, n_layers_override=layers)


@pytest.fixture
def smoke_registry(monkeypatch):
    """The registry's LM archs at their smoke configs and shapes."""
    monkeypatch.setattr(SP, "get_arch", _smoke)
    monkeypatch.setattr(D, "get_arch", _smoke)


def _forward_parts(cfg, B: int, S: int) -> tuple[int, int]:
    """(FLOPs of the layers' forward, of one layer's down projection) as
    the port computes them: the projections, the attention's two products
    over every (query, padded key) pair of every head, the FFN (the MoE's
    router and expert products over its capacity buffer)."""
    T, d = B * S, cfg.d_model
    H = cfg.n_heads
    if cfg.attn == "mla":
        qk = cfg.nope_dim + cfg.rope_dim
        proj = (d * cfg.q_lora_rank + cfg.q_lora_rank * H * qk
                + d * (cfg.kv_lora_rank + cfg.rope_dim)
                + cfg.kv_lora_rank * H * (cfg.nope_dim + cfg.v_dim)
                + H * cfg.v_dim * d)
        head = qk                          # v padded to qk
    else:
        proj = d * cfg.head_dim * (H + 2 * cfg.n_kv) + H * cfg.head_dim * d
        head = cfg.head_dim
    chunk = min(cfg.kv_chunk, S)
    s_pad = -(-S // chunk) * chunk
    attn = 2 * 2 * B * H * S * s_pad * head
    if cfg.moe:
        C = max(1, int(cfg.capacity_factor * cfg.top_k * T / cfg.n_experts))
        ffn = 2 * T * d * cfg.n_experts + 6 * cfg.n_experts * C * d * cfg.d_ff
        down = 2 * cfg.n_experts * C * cfg.d_ff * d
    else:
        ffn = 6 * T * d * cfg.d_ff
        down = 2 * T * cfg.d_ff * d
    return cfg.n_layers * (2 * T * proj + attn + ffn), cfg.n_layers * down


@pytest.mark.parametrize("name", LM_SMOKE)
def test_train_flops_closed_form(name):
    """One ``Trainer`` step of the smoke config on a (1, 1) mesh: the
    forward (layers + logits), the layers recomputed in the backward up to
    their last saved tensor (a dense layer's all but its down projection;
    the MoE saves tensors past its experts, so all of it), and a backward
    of twice the forward."""
    arch = _smoke(name)
    cfg = arch.smoke_config
    mesh = Mesh(np.full((1, 1), "meta", dtype=object), ("data", "model"))
    for layers in (1, 3):
        sh = SMOKE_SHAPES[0]
        B, S = sh.params["batch"], sh.params["seq"]
        c = dataclasses.replace(cfg, n_layers=layers)
        fwd, down = _forward_parts(c, B, S)
        logits = 2 * B * S * cfg.d_model * cfg.padded_vocab
        want = 3 * (fwd + logits) + fwd - (0 if cfg.moe else down)
        got = D.count_spec(_smoke_spec(arch, sh, mesh, layers)).flops
        assert got == want, (name, layers, got, want)


@pytest.mark.parametrize("name", LM_SMOKE)
def test_prefill_flops_closed_form(name):
    """Prefill: the layers' forward, each layer's cache entries projected
    again (k and v, or MLA's ``wkv_a``), the last position's logits."""
    arch = _smoke(name)
    cfg = arch.smoke_config
    mesh = Mesh(np.full((1, 1), "meta", dtype=object), ("data", "model"))
    sh = SMOKE_SHAPES[1]
    B, S = sh.params["batch"], sh.params["seq"]
    fwd, _ = _forward_parts(cfg, B, S)
    d = cfg.d_model
    width = (cfg.kv_lora_rank + cfg.rope_dim if cfg.attn == "mla"
             else 2 * cfg.n_kv * cfg.head_dim)
    want = fwd + cfg.n_layers * 2 * B * S * d * width \
        + 2 * B * d * cfg.padded_vocab
    assert D.count_spec(_smoke_spec(arch, sh, mesh)).flops == want


@pytest.mark.parametrize("name", LM_SMOKE)
def test_depth_extrapolation_is_exact(smoke_registry, name):
    """The 2- and 4-layer traces extrapolated to 7 layers equal a 7-layer
    trace: FLOPs, bytes and collectives exactly, and the temp bytes too
    for the dense LMs."""
    mesh = Mesh(np.full((2, 2), "meta", dtype=object), ("data", "model"))
    for sh in SMOKE_SHAPES:
        spec = SP.build_lowering_spec(name, sh.name, mesh,
                                      n_layers_override=7)
        got = D.lm_counts(name, sh.name, mesh, spec)
        want = D.lm_sample(name, sh.name, mesh, 7)
        assert got.flops == want.flops, sh.name
        assert got.hbm_bytes == want.hbm_bytes, sh.name
        assert got.collectives.op_counts == want.collectives.op_counts
        assert got.collectives.op_bytes == want.collectives.op_bytes
        if not get_arch(name).config.moe:
            assert got.temp_bytes == want.temp_bytes, sh.name


@pytest.mark.parametrize("mesh_shape", [(2, 2), (2, 1, 2)])
@pytest.mark.parametrize("name", ("yi-6b", "granite-moe-3b-a800m",
                                  "phi3.5-moe-42b-a6.6b"))
def test_data_axis_scaling_equals_full_mesh(smoke_registry, name,
                                            mesh_shape):
    """Traced on the (1, model) mesh at one data shard's batch and scaled,
    the per-device FLOPs and the MoE's collectives equal a trace of the
    whole batch on the full mesh, for every shape whose batch splits."""
    names = ("pod", "data", "model")[-len(mesh_shape):]
    mesh = Mesh(np.full(mesh_shape, "meta", dtype=object), names)
    for sh in SMOKE_SHAPES:
        if D._data_split(sh.params["batch"], mesh) == 1:
            continue
        got = D.lm_sample(name, sh.name, mesh, 2)
        spec = SP.build_lowering_spec(name, sh.name, mesh,
                                      n_layers_override=2)
        full = D.count_spec(spec)
        assert got.flops == full.flops, sh.name
        assert got.collectives.op_counts == full.collectives.op_counts
        assert got.collectives.op_bytes == full.collectives.op_bytes


# -- the rules' collectives against hand counts ----------------------------------------

def _hand(*items) -> dict:
    """``{op: (count, wire bytes)}`` of (op, out_bytes, k, n) items."""
    out = {}
    for op, b, k, n in items:
        w = {"all-reduce": 2 * b * (k - 1) / k, "all-gather": b * (k - 1) / k,
             "all-to-all": b * (k - 1) / k, "reduce-scatter": b * (k - 1),
             "collective-permute": b}[op]
        c, s = out.get(op, (0, 0.0))
        out[op] = (c + n, s + n * w)
    return out


def _rules(name: str, shape: str) -> dict:
    mesh = Mesh(np.full((2, 2), "meta", dtype=object), ("data", "model"))
    st = D.rule_collectives(name, shape, SP.build_lowering_spec(
        name, shape, mesh), mesh)
    return {op: (st.op_counts[op], st.op_bytes[op]) for op in st.op_counts}


# the smoke configs' parameters, per device of (2, 2): yi-6b's embed
# (256, 64) cut on rows: 8,192 elements; wq and wo 2 x 64 x 32 = 4,096;
# wk, wv 2 x 64 x 16 = 2,048; w_gate, w_up, w_down 2 x 64 x 80 = 10,240
# (granite: 2 x 5 x 64 x 16, the same); ln1, ln2 2 x 64 = 128; ln_f 64;
# unembed (64, 256) cut on rows: 8,192 -> 59,712 bf16 elements, 119,424
# bytes; granite adds its float32 router 2 x 64 x 5 = 640 elements (2,560
# bytes).  Every leaf's moments are cut again over data (ZeRO-1), so each
# leaf's gradient is reduce-scattered (out g/2, wire g/2) and its update
# all-gathered (wire g/2): 12 + 12 collectives for yi, 13 + 13 for granite.
YI_PARAM_BYTES, GRANITE_PARAM_BYTES = 119_424, 119_424 + 2_560


def test_rules_yi_train_hand_count(smoke_registry):
    """yi-6b smoke ``train`` (batch 8, seq 64) over (2, 2): T = 4 x 64 =
    256 tokens a data shard, (T, d) bf16 = 32,768 bytes.  Per layer 2
    forward row-parallel all-reduces, 1 recomputed (wo), 2 backward: 10;
    the unembedding's shard (64 x 256 x 2 / 2 = 16,384 bytes) re-cut
    forward and back; 3 softmax statistics of T x 4 = 1,024 bytes; the
    logits' input gradient.  (The embedding's lookup is the trace's.)"""
    got = _rules("yi-6b", "train_4k")
    want = _hand(("all-reduce", 32_768, 2, 10 + 1),
                 ("all-reduce", 1_024, 2, 3),
                 ("all-to-all", 16_384, 2, 2),
                 ("reduce-scatter", YI_PARAM_BYTES / 2, 2, 1),
                 ("all-gather", YI_PARAM_BYTES, 2, 1))
    assert got["all-reduce"] == want["all-reduce"]
    assert got["all-to-all"] == want["all-to-all"]
    assert got["reduce-scatter"] == (12, want["reduce-scatter"][1])
    assert got["all-gather"] == (12, want["all-gather"][1])


def test_rules_granite_train_hand_count(smoke_registry):
    """granite smoke ``train``: as yi-6b's, but the FFN is the MoE, whose
    forward all-reduce is its own traced psum: per layer 1 forward (wo),
    1 recomputed, 2 backward: 8; and 13 leaves (the router)."""
    got = _rules("granite-moe-3b-a800m", "train_4k")
    want = _hand(("all-reduce", 32_768, 2, 8 + 1),
                 ("all-reduce", 1_024, 2, 3),
                 ("all-to-all", 16_384, 2, 2))
    assert got["all-reduce"] == want["all-reduce"]
    assert got["all-to-all"] == want["all-to-all"]
    assert got["reduce-scatter"] == (13, GRANITE_PARAM_BYTES / 2 * 1)
    assert got["all-gather"] == (13, GRANITE_PARAM_BYTES / 2)


def test_rules_serving_hand_count(smoke_registry):
    """prefill (batch 4, seq 64: T = 2 x 64 = 128, 16,384 bytes) and
    decode (batch 8: 4 lanes a data shard) over (2, 2), yi-6b smoke: 2
    row-parallel all-reduces a layer; the last position's partial logits
    (lanes x 256 x 4 bytes) all-reduced, the unembedding's rows being cut;
    prefill re-cuts each layer's k and v shard (2 lanes x 32 slots x 2
    heads x 16 x 2 bytes, twice: 8,192 bytes); decode gathers q (4 x 4 x
    16 x 2 = 512 bytes) and the new entry (4 x 2 x 2 x 16 x 2 = 512) and
    all-reduces the partial softmax (4 x 4 x (16 + 2) x 4 = 1,152) per
    layer."""
    got = _rules("yi-6b", "prefill_32k")
    assert got == _hand(("all-reduce", 16_384, 2, 2 * 2),
                        ("all-reduce", 2 * 256 * 4, 2, 1),
                        ("all-to-all", 8_192, 2, 2))
    got = _rules("yi-6b", "decode_32k")
    assert got == _hand(("all-reduce", 4 * 64 * 2, 2, 2 * 2),
                        ("all-reduce", 4 * 256 * 4, 2, 1),
                        ("all-gather", 512, 2, 2),
                        ("all-gather", 512, 2, 2),
                        ("all-reduce", 1_152, 2, 2))


def test_counter_splits_and_collectives():
    """A toy step on a (2, 2) mesh: a lookup of data-cut ids into a table
    whose rows are cut over model, the looked-up rows times a weight
    whose rows are cut over model, scatter-added through data-cut ids into
    a fresh (5, 6) array.  The lookup and the product each all-reduce
    their per-device output over model (3 of the 6 rows: 48 and 72
    bytes), the scatter-add its whole destination over data (120 bytes);
    the product's 288 FLOPs run split over both axes (72 a device), the
    scatter-add's result is not split."""
    mesh = Mesh(np.full((2, 2), "meta", dtype=object), ("data", "model"))
    f32 = torch.float32

    def step(table, w, ids, dst):
        h = table[ids.long()] @ w
        return torch.zeros((5, 6), dtype=f32, device=h.device).index_add_(
            0, dst.long(), h)

    spec = SP.LoweringSpec(
        fn=step, args=(torch.empty((8, 4), device="meta"),
                       torch.empty((4, 6), device="meta"),
                       torch.empty((6,), dtype=torch.int32, device="meta"),
                       torch.empty((6,), dtype=torch.int32, device="meta")),
        in_shardings=(P("model", None), P("model", None), P("data"),
                      P("data")),
        out_shardings=P(), mesh=mesh)
    tr = D.trace(spec)
    assert tr.calls == [("all-reduce", ("model",), 48.0),
                        ("all-reduce", ("model",), 72.0),
                        ("all-reduce", ("data",), 120.0)]
    assert tr.flops == 72.0
    c = D.count_spec(spec)
    assert c.collectives.op_counts == {"all-reduce": 3}
    assert c.collectives.wire_bytes == 48.0 + 72.0 + 120.0


def test_moe_traced_collectives_hand_count(smoke_registry):
    """granite smoke ``train`` over (2, 2), 2 layers: each MoE call psums
    its aux statistics over data (5 and 5 float32, 20 bytes each, and a
    float32 scalar) and its (256, 64) bf16 output (32,768 bytes) over
    model.  The forward calls it once a layer; the recompute stops at the
    layer's last saved tensor, after the aux psums and before the
    output's: 2 x 4 + 2 x 3 = 14 all-reduces.  The embedding's lookup
    into its model-cut rows adds one of its (256, 64) bf16 output.  Each
    has wire = its bytes."""
    mesh = Mesh(np.full((2, 2), "meta", dtype=object), ("data", "model"))
    got = D.lm_sample("granite-moe-3b-a800m", "train_4k", mesh, 2)
    want = _hand(("all-reduce", 20, 2, 8), ("all-reduce", 4, 2, 4),
                 ("all-reduce", 32_768, 2, 2 + 1))
    assert got.collectives.op_counts == {"all-reduce": 15}
    assert got.collectives.op_bytes == {"all-reduce": want["all-reduce"][1]}
    assert want["all-reduce"] == (15, 98_480.0)


# -- the production pass, the launcher, elastic restore ------------------------------

def test_run_cell_every_cell_single_pod():
    """Every cell on the (16, 16) mesh of meta entries: ``"ok"``, positive
    counts, the reference's record keys (~40 s on one worker; the smoke's
    phase 15 runs both meshes)."""
    recs = [D.run_cell(a, s, False, verbose=False) for a, s in
            SP.all_cells()]
    assert len(recs) == 43
    for r in recs:
        assert r["status"] == "ok" and r["devices"] == 256
        assert set(r) == {"arch", "shape", "variant", "mesh", "devices",
                          "lower_s", "compile_s", "memory", "roofline",
                          "status"}
        m = r["memory"]
        assert m["peak_bytes"] == m["temp_bytes"] + m["argument_bytes"]
        assert m["argument_bytes"] > 0 and r["roofline"]["hbm_bytes"] > 0
        assert r["roofline"]["bottleneck"] in ("compute", "memory",
                                               "collective")
        if get_arch(r["arch"]).family == "lm":
            assert r["roofline"]["flops"] > 0
            assert 0 < r["roofline"]["useful_ratio"] < 1.5


def test_dryrun_main_writes_records(tmp_path, capsys):
    out = tmp_path / "r.json"
    recs = D.main(["--arch", "granite-moe-3b-a800m", "--shape",
                   "decode_32k", "--multi-pod", "--out", str(out)])
    assert [r["status"] for r in recs] == ["ok"]
    assert json.loads(out.read_text())[0]["mesh"] == "2x16x16"
    assert "1/1 cells compiled" in capsys.readouterr().out


def test_train_launcher_production_mode(capsys):
    """``launch/train.py --arch yi-6b`` without ``--smoke``: the dry run's
    record of ``train_4k`` on the production mesh."""
    rec = launch_train.main(["--arch", "yi-6b"])
    assert rec["status"] == "ok" and rec["shape"] == "train_4k"
    assert rec["mesh"] == "16x16"
    assert rec["memory"]["argument_bytes"] == 948_185_092   # repro's sum
    assert "[yi-6b × train_4k @ 16x16]" in capsys.readouterr().out


@pytest.mark.parametrize("mk", list(RESTORE_MESHES))
def test_restore_shardings_equal_repro(repro_side, mk, tmp_path):
    """A checkpoint saved whole, restored onto a (2, 2) and a (1, 4)
    mesh: every shard equals ``repro``'s ``addressable_shards`` entry at
    that coordinate, bit for bit; the model comes back as its stacked
    tree's shards."""
    _, arrays, state = repro_side
    CheckpointManager(str(tmp_path)).save(5, state)
    mesh, specs, tree = _restore_specs(state, RESTORE_MESHES[mk])

    def pairs(t):
        if isinstance(t, P):
            return (mesh, t)
        if isinstance(t, OptState):
            return OptState(*(pairs(v) for v in t))
        return {k: pairs(v) for k, v in t.items()}

    cm = CheckpointManager(str(tmp_path))
    restored, _ = cm.restore(5, state, shardings=pairs(tree))
    got = dict(SP.spec_leaves(specs))
    n = 0
    flat = {}

    def walk(t, prefix=""):
        if isinstance(t, list):
            flat[prefix] = t
            return
        items = (zip((f".{f}" for f in t._fields), t) if isinstance(
            t, OptState) else t.items())
        for k, v in items:
            walk(v, f"{prefix}/{k}" if prefix else k)

    walk(restored)
    assert sorted(flat) == sorted(got)
    for path, shards in flat.items():
        assert len(shards) == 4
        for c, s in enumerate(shards):
            want = arrays[f"{mk}|{path}|{c}"]
            have = s.float().numpy() if s.dtype == torch.bfloat16 \
                else s.numpy()
            assert have.dtype == want.dtype and np.array_equal(have, want), \
                (path, c)
            n += 1
    assert n == 4 * len(flat)
    # the shards are those of the saved state, cut by shard_tensor
    embed = shard_tensor(state["params"].embed.detach(),
                         got["params/embed"], mesh)
    assert all(torch.equal(a, b) for a, b in
               zip(embed, flat["params/embed"]))
