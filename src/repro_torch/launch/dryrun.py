"""Multi-pod dry run on the meta device: every (architecture × input
shape) cell's step on the production meshes, with its roofline terms on
the H100; the port of ``repro/launch/dryrun.py``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all   # 43 cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes \\
      --out results.json

Single pod:  (data=16, model=16)         = 256 cards
Multi pod:   (pod=2, data=16, model=16)  = 512 cards

The reference lowers and compiles each cell with XLA on 512 virtual host
devices and reads the compiled artifact.  The port runs nothing on a card
and allocates nothing: the meshes hold meta entries, the specs' arguments
are meta tensors (``launch/specs.py``), and each quantity is counted so:

* **argument and output bytes per device** — exact from the specs: per
  leaf, the largest block its spec cuts (``sharding.shard_shape``: a dim
  split over the named axes, rounded up, as JAX pads an uneven shard).  An LM's
  outputs are its step's: the parameters and moments (train), or the
  logits (B, V) float32 and the KV cache (prefill, decode).
* **FLOPs and bytes** — one trace of the cell's ``fn`` on the meta device
  under ``FlopCounterMode`` (the products' FLOPs, what the tensor cores'
  peak divides; elementwise work is not counted) and :class:`_Counter`,
  which counts each op's tensor inputs read once and its outputs written
  once (views and allocations count zero).  Training traces what the
  port's ``Trainer`` runs: the loss, ``backward`` with each LM layer
  recomputed, ``adamw_update``.  Per device, op by op: every tensor
  carries the mesh axes it is split over (an argument those its spec
  names), and an op counts divided by the extents of its inputs' axes.
  A row-parallel product's output is whole over the axes that cut its
  weight's rows; a lookup's output is split as its ids are; an op of a
  per-coordinate body (the MoE's) is one coordinate's.  So an LM's
  residual stream and norms repeat over ``model`` (Megatron), a recsys
  model's dense layers over ``model`` (only its tables are cut there),
  and an axis that splits no input repeats the work, as XLA's
  per-partition counts do.
* **temp bytes** — the largest per-device live set of the trace: the
  storages that its ops create and that are alive at once, each divided
  by the extents of its own axes; ``peak_bytes`` = temp + argument, as
  the reference's.
* **depth** — an LM cell is traced at 2 and 4 layers and extrapolated
  linearly to its depth, as the reference's ``lm_exact_terms``: the
  port's per-layer cost is linear in L (its layer loop is Python), and
  this keeps L layers of per-coordinate MoE work out of the run.
  ``--exact-lm`` is accepted and is the only behaviour.
* **data axes** — an LM cell is traced on a (1, model) mesh ((1, 1,
  model) multi-pod) at the global batch divided by the data extent: one
  data shard's step, which is each device's.  The per-coordinate MoE
  (``moe_ffn_sharded`` runs once per mesh coordinate) is the cost of a
  trace; per coordinate the work is that of the full mesh, since the
  batch splits evenly.  A batch that does not split over the data axes
  (``long_500k``'s one lane) is traced whole: every data shard repeats
  it.  Where the batch splits, the FLOPs and the collectives equal a
  full-mesh trace's.  FLOPs, bytes, collectives and the dense LMs' temp
  bytes extrapolate in depth exactly; the MoE's temp bytes to within the
  capacity buffers' live ranges (a few per cent at smoke size).
* **collectives** — per device, through
  :meth:`~.hlo_analysis.CollectiveStats.add_collective`'s ring formulas,
  from two sources.  The trace (:class:`_Counter`) records an all-reduce
  for each lookup into rows cut over an axis (an LM's embedding, the
  recsys tables, the GNN's first-layer gather of data-cut node features),
  each scatter-add through ids cut over an axis its destination is not
  (the GNN's aggregation), each row-parallel product outside the LMs
  (bst's model-cut MLP), and ``moe_ffn_sharded``'s own
  ``spmd.psum``/``pmax``/``ppermute`` calls (:func:`~..distributed.spmd.
  recording`), each over the full mesh's extents of its axes.  The rules
  give the rest.  DP is the data extent (pod × data), TP the ``model``
  extent, ``T`` the tokens of one data shard (``B/DP`` lanes when the
  batch splits, else ``B``, × the sequence for train and prefill), ``d``
  the width:

  - *gradients* (training steps): per parameter leaf, its shard's
    gradient is reduce-scattered over DP and the updated shard
    all-gathered where ZeRO-1 splits its moments (``zero1_spec`` differs
    from the leaf's spec), else all-reduced;
  - *Megatron TP* (LM, TP > 1): per layer, one all-reduce of (T, d) bf16
    over TP per row-parallel product (``wo``, the dense FFN's
    ``w_down``) per forward pass; in training the layer's recompute
    redoes ``wo``'s (it stops at the layer's last saved tensor, the
    down projection's input, so it never reruns ``w_down``), and the
    backward adds two (the attention's and the FFN's input gradients);
  - *logits* (LM, TP > 1): the unembedding's rows are cut over ``model``.
    Training re-cuts it into vocab columns by an all-to-all of its shard
    (and its gradient back), then reduces the softmax's max, sum and
    gold logit (three all-reduces of (T,) float32) and the input
    gradient ((T, d) bf16); serving all-reduces the last position's
    partial logits, (B/DP, V) float32;
  - *KV cache over ``model``*: prefill re-cuts each layer's cache from
    heads to sequence (one all-to-all of its shard); decode gathers the
    query heads and the new token's cache entry (two all-gathers) and
    combines the partial softmaxes (an all-reduce of (B/DP, H, d_v + 2)
    float32) per layer.

  These are the rules' choices, not a partitioner's: ``repro``'s
  compiled programs (XLA on 8 CPU devices) gather whole LM weights and
  re-cut decode caches instead; ``tests/test_torch_dryrun.py`` holds
  every cell's counts beside XLA's with the causes of each difference.

A record has the reference's keys; its ``lower_s`` is the seconds to
build the cell's spec and ``compile_s`` the seconds of its traces.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
import traceback
import weakref

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from ..configs import get_arch
from ..distributed import spmd
from ..distributed.sharding import Mesh, P, dp_axes, shard_shape
from ..models.transformer import Transformer
from ..train.tree import leaves_with_paths, parts
from .hlo_analysis import CollectiveStats, roofline_from_counts
from .mesh import make_production_mesh
from .specs import LoweringSpec, all_cells, build_lowering_spec, spec_leaves


def model_flops_for(arch_name: str, shape_name: str) -> float:
    """6·N·D useful-FLOPs accounting (per whole step, fwd+bwd for train,
    fwd for serve).  Non-LM families report 0 (no 6ND convention)."""
    arch = get_arch(arch_name)
    if arch.family != "lm":
        return 0.0
    cfg = arch.config
    shape = arch.shape(shape_name)
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        toks = shape.params["batch"] * shape.params["seq"]
        return 6.0 * n_active * toks
    if shape.kind == "prefill":
        toks = shape.params["batch"] * shape.params["seq"]
        return 2.0 * n_active * toks
    # decode: one token per lane
    return 2.0 * n_active * shape.params["batch"]


# -- bytes of shards ------------------------------------------------------------

def shard_bytes(leaf, spec: P, mesh: Mesh) -> int:
    """Per-device bytes of ``leaf`` under ``spec`` (``shard_shape``)."""
    return math.prod(shard_shape(leaf.shape, spec, mesh)) * \
        leaf.dtype.itemsize


def tree_shard_bytes(tree, specs, mesh: Mesh) -> int:
    """Per-device bytes of every leaf of ``tree`` under ``specs`` (a tree
    of :class:`P` of the same paths)."""
    sp = spec_leaves(specs)
    return sum(shard_bytes(leaf, sp[path], mesh)
               for path, leaf in leaves_with_paths(tree))


def _names(e) -> tuple[str, ...]:
    return tuple(e) if isinstance(e, tuple) else ((e,) if e else ())


# -- the trace -------------------------------------------------------------------

_ALLOCATIONS = {torch.ops.aten.empty.memory_format,
                torch.ops.aten.empty_strided.default,
                torch.ops.aten.new_empty.default,
                torch.ops.aten.new_empty_strided.default,
                torch.ops.aten._unsafe_view.default,
                torch.ops.aten.lift_fresh.default}
_LOOKUPS = {torch.ops.aten.index.Tensor, torch.ops.aten.embedding.default}
_SCATTER_ADDS = {torch.ops.aten.index_add.default,
                 torch.ops.aten.index_add_.default}
_PRODUCTS = {torch.ops.aten.mm, torch.ops.aten.addmm}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Counter(TorchDispatchMode):
    """The per-device share of each op of a trace, and the collectives
    that products, lookups and scatters of split tensors imply.

    Every storage carries the set of mesh axes it is split over: an
    argument those its spec names, an op's output the union of its
    inputs', an op of a per-coordinate body (:func:`~..distributed.spmd.
    per_coordinate`, the MoE's) every axis, as one coordinate's work.  An
    op runs once per device on its split, so its FLOPs (read from ``fc``,
    a ``FlopCounterMode`` entered below this mode) and its bytes (its
    tensor inputs read once, its outputs written once; views and
    allocations none) count divided by the product of the extents of the
    axes its inputs are split over.  Three ops differ; each implies an
    all-reduce over axes A, recorded in ``calls`` as (op, axes,
    per-device output bytes):

    * a product ``x @ w`` (``mm``, ``addmm``) with ``w`` an argument as it
      is held whose rows are cut over A (a row-parallel product): each
      device sums its rows, the partial products are summed, and the
      output is not split over A.  Not recorded in an LM's step, whose
      products the Megatron rules count; its unembedding in training is
      re-cut into columns instead (the rules count that), so that
      product's output stays split;
    * a lookup (``embedding``, an ``index`` on dim 0) into an argument as
      it is held whose rows are cut over A: each device looks up the ids
      in its rows, the outputs are summed; the output is split as the ids
      are;
    * a scatter-add (``index_add``) through ids split over A into a tensor
      that is not: each device adds its part, the whole is summed, and
      the tensor stays as it was split.

    In an LM's step whose ``sp_axis`` cuts the residual stream's
    sequence, the first two sums are reduce-scattered onto the
    sequence instead, which the next product's all-gather undoes
    (together the wire bytes of the all-reduce), so their outputs stay
    split over A.  ``peak`` is the largest per-device set of storages that
    the ops create and that are alive at once (the arguments' are not
    counted)."""

    def __init__(self, fc: FlopCounterMode, spec: LoweringSpec):
        super().__init__()
        self._fc = fc
        self._extents = dict(spec.mesh.shape)
        model = spec.args[0]
        lm = isinstance(model, Transformer)
        self._products = not lm
        self._sp = lm and model.cfg.sp_axis is not None
        self._recut = {id(model.unembed.untyped_storage())} \
            if lm and spec.kind == "train" else set()
        self._axes: dict[int, frozenset] = {}
        self._rows: dict[int, tuple] = {}  # (shape, stride, dim 0's axes)
        sp = spec_leaves(spec.in_shardings)
        self._keep = []
        for path, leaf in leaves_with_paths(spec.args):
            spec = sp[path]
            for t in parts(leaf):
                st = t.untyped_storage()
                self._keep.append(st)
                self._axes[id(st)] = frozenset(
                    a for e in spec for a in _names(e))
                d0 = leaf.ndim - t.ndim     # a Stacked part's dim 0
                self._rows[id(st)] = (tuple(t.shape), t.stride(), _names(
                    spec[d0]) if t.ndim and d0 < len(spec) else ())
        self._external = set(self._axes)
        self._live: dict[int, float] = {}
        self.flops = 0.0
        self.bytes = 0.0
        self.live = 0.0
        self.peak = 0.0
        self.calls: list = []

    def axes(self, t: torch.Tensor) -> frozenset:
        return self._axes.get(id(t.untyped_storage()), frozenset())

    def _cut_rows(self, t: torch.Tensor) -> frozenset:
        """The axes that cut the rows of ``t``, an argument as held."""
        shape, stride, rows = self._rows.get(id(t.untyped_storage()),
                                             (None, None, ()))
        return frozenset(rows) if (shape, stride) == (
            tuple(t.shape), t.stride()) else frozenset()

    def _extent(self, axes) -> int:
        return math.prod(self._extents[a] for a in axes)

    def _free(self, sid: int) -> None:
        self.live -= self._live.pop(sid, 0.0)
        self._axes.pop(sid, None)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        f0 = self._fc.get_total_flops()
        out = func(*args, **kwargs)
        flops = self._fc.get_total_flops() - f0
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        work = frozenset().union(*(self.axes(t) for t in ins))
        made = work                     # the axes the outputs carry
        body = spmd.body_mesh()
        if body is not None:            # one coordinate's op
            work = made = frozenset(body.axis_names)
        elif func.overloadpacket in _PRODUCTS:
            w = args[1] if func.overloadpacket is torch.ops.aten.mm \
                else args[2]
            cut = self._cut_rows(w)
            if cut and id(w.untyped_storage()) not in self._recut:
                made = work if self._sp else work - cut
                if self._products:
                    self.calls.append(("all-reduce", tuple(sorted(cut)),
                                       _nbytes(out) / self._extent(made)))
        elif func in _LOOKUPS and (func is torch.ops.aten.embedding.default
                                   or args[1][0] is not None):
            src = args[0]
            ids = args[1] if func is torch.ops.aten.embedding.default \
                else args[1][0]
            cut = self._cut_rows(src)
            work = made = self.axes(ids) | (self.axes(src) - cut)
            if cut:
                self.calls.append(("all-reduce", tuple(sorted(cut)),
                                   _nbytes(out) / self._extent(work)))
                if self._sp:
                    made = work | cut
        elif func in _SCATTER_ADDS:
            made = self.axes(args[0])
            over = self.axes(args[2]) - made
            if over:
                self.calls.append(("all-reduce", tuple(sorted(over)),
                                   _nbytes(args[0]) / self._extent(made)))
        ext = self._extent(work)
        self.flops += flops / ext
        if not func.is_view and func not in _ALLOCATIONS:
            self.bytes += sum(_nbytes(t) for t in ins + outs) / ext
        for t in outs:
            st = t.untyped_storage()
            sid = id(st)
            if sid in self._external or func.is_view:
                continue
            if sid in self._axes:       # written in place
                if sid in self._live:
                    self._axes[sid] = axes = made
                    n = st.nbytes() / self._extent(axes)
                    self.live += n - self._live[sid]
                    self._live[sid] = n
                continue
            self._axes[sid] = made
            n = st.nbytes() / self._extent(made)
            self._live[sid] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, sid)
        return out


@dataclasses.dataclass
class Trace:
    flops: float                 # matmul FLOPs of the step, per device
    bytes: float                 # bytes its ops read and write, per device
    temp: float                  # largest per-device live set it creates
    out: object                  # the step's outputs (meta tensors)
    calls: list                  # (op, axes, per-device bytes) of the
    #                              collectives the step implies


def trace(spec: LoweringSpec) -> Trace:
    """``spec.fn(*spec.args)`` once, counted per device of ``spec.mesh``
    by :class:`_Counter`; the MoE's own spmd calls join the
    collectives."""
    calls = []

    def note(op, axes, xs, mesh):
        calls.append((op, axes, _nbytes(xs[0])))

    with spmd.recording(note), FlopCounterMode(display=False) as fc, \
            _Counter(fc, spec) as tr:
        out = spec.fn(*spec.args)
    return Trace(flops=tr.flops, bytes=tr.bytes, temp=tr.peak,
                 out=out, calls=calls + tr.calls)


def traced_collectives(calls, mesh: Mesh, data_split: bool
                       ) -> CollectiveStats:
    """The spmd calls of a trace as per-device collectives over ``mesh``
    (the production mesh): a group spans the extents of the axes a call
    names; the data axes only when the batch splits over them (else
    ``moe_ffn_sharded`` replicates the tokens and reduces over none)."""
    stats = CollectiveStats()
    dp = set(dp_axes(mesh))
    for op, axes, nbytes in calls:
        k = math.prod(mesh.shape[a] for a in axes
                      if data_split or a not in dp)
        stats.add_collective(op, nbytes, k)
    return stats


# -- the rules' collectives ----------------------------------------------------------

def _data_split(batch: int, mesh: Mesh) -> int:
    """The data extent when a batch of ``batch`` splits over it, else 1."""
    dp = math.prod(mesh.shape[a] for a in dp_axes(mesh))
    return dp if batch % dp == 0 and batch >= dp else 1


def rule_collectives(arch_name: str, shape_name: str, spec: LoweringSpec,
                     mesh: Mesh) -> CollectiveStats:
    """The per-device collectives of the cell's step that the rules imply
    (the module docstring's list, the MoE's traced ones aside); ``spec``
    is the cell's spec on the production ``mesh``."""
    arch = get_arch(arch_name)
    shape = arch.shape(shape_name)
    stats = CollectiveStats()
    DP = math.prod(mesh.shape[a] for a in dp_axes(mesh))
    TP = mesh.shape.get("model", 1)
    if spec.trains:
        pspecs = spec_leaves(spec.in_shardings[0])
        ospecs = spec_leaves(spec.in_shardings[1].mu)
        for path, leaf in leaves_with_paths(spec.args[0]):
            g = shard_bytes(leaf, pspecs[path], mesh)
            if ospecs[path] != pspecs[path]:
                stats.add_collective("reduce-scatter", shard_bytes(
                    leaf, ospecs[path], mesh), DP)
                stats.add_collective("all-gather", g, DP)
            else:
                stats.add_collective("all-reduce", g, DP)
    if arch.family != "lm" or TP <= 1:
        return stats
    cfg = spec.args[0].cfg
    L, d, V = cfg.n_layers, cfg.d_model, cfg.padded_vocab
    Bl = shape.params["batch"] // _data_split(shape.params["batch"], mesh)
    train = spec.kind == "train"
    seq = shape.params["seq"] if shape.kind in ("train", "prefill") else 1
    T = Bl * seq
    act = T * d * 2
    rows = 1 if cfg.moe else 2             # the MoE's own psum is traced
    stats.add_collective("all-reduce", act, TP,
                         n=L * (rows + 1 + 2 if train else rows))
    if train:
        stats.add_collective("all-to-all", d * V * 2 // TP, TP,
                             n=2)                          # unembedding
        stats.add_collective("all-reduce", T * 4, TP, n=3)  # softmax stats
        stats.add_collective("all-reduce", act, TP)          # logits' dx
    else:
        stats.add_collective("all-reduce", Bl * V * 4, TP)  # last logits
    if shape.kind == "prefill":
        cache = tree_shard_bytes(_outputs(spec)[1], spec.out_shardings[1],
                                 mesh)
        stats.add_collective("all-to-all", cache // L, TP, n=L)
    elif shape.kind in ("decode", "long_decode"):
        H = cfg.n_heads
        if cfg.attn == "mla":
            qk, dv = cfg.nope_dim + cfg.rope_dim, cfg.v_dim
            entry = cfg.kv_lora_rank + cfg.rope_dim
        else:
            qk = dv = cfg.head_dim
            entry = 2 * cfg.n_kv * cfg.head_dim
        stats.add_collective("all-gather", Bl * H * qk * 2, TP, n=L)
        stats.add_collective("all-gather", Bl * entry * 2, TP, n=L)
        stats.add_collective("all-reduce", Bl * H * (dv + 2) * 4, TP, n=L)
    return stats


def _outputs(spec: LoweringSpec):
    """An LM step's outputs as meta tensors: train returns its parameters,
    moments and three float32 scalars; prefill and decode the logits
    (B, V) float32 and the cache."""
    model = spec.args[0]
    if spec.kind == "train":
        scalars = {k: torch.empty((), device="meta") for k in
                   ("grad_norm", "lr", "loss")}
        return model, spec.args[1], scalars
    from ..models.transformer import init_cache_shape
    B = spec.args[1].shape[0]
    if spec.kind == "prefill":
        cache = {k: torch.empty(s, dtype=dt, device="meta") for k, (s, dt)
                 in init_cache_shape(model.cfg, B,
                                     spec.args[1].shape[1]).items()}
    else:
        cache = spec.args[2]
    return torch.empty((B, model.cfg.padded_vocab), device="meta"), cache


# -- a cell -----------------------------------------------------------------------------

@dataclasses.dataclass
class Counts:
    """Per-device quantities of one cell's step."""
    argument_bytes: int
    output_bytes: int
    temp_bytes: float
    flops: float
    hbm_bytes: float
    collectives: CollectiveStats


def count_spec(spec: LoweringSpec) -> Counts:
    """One trace of ``spec`` at its shapes, per device of its mesh, with
    the collectives the trace implies (:func:`trace`)."""
    mesh = spec.mesh
    tr = trace(spec)
    return Counts(
        argument_bytes=tree_shard_bytes(spec.args, spec.in_shardings, mesh),
        output_bytes=tree_shard_bytes(tr.out, spec.out_shardings, mesh),
        temp_bytes=tr.temp, flops=tr.flops, hbm_bytes=tr.bytes,
        collectives=traced_collectives(tr.calls, mesh, True))


def _trace_mesh(mesh: Mesh) -> Mesh:
    """``mesh`` with every axis but ``model`` cut to 1, of meta entries."""
    shape = [mesh.shape[a] if a == "model" else 1 for a in mesh.axis_names]
    return Mesh(np.full(shape, "meta", dtype=object), mesh.axis_names)


def lm_sample(arch_name: str, shape_name: str, mesh: Mesh, layers: int,
              variant: str = "baseline") -> Counts:
    """An LM cell at ``layers`` layers, per device of ``mesh``: one trace
    on the (1, model) mesh at the batch of one data shard (the batch whole
    where it does not split over the data axes, whose devices then repeat
    the work); the argument and output bytes are left 0."""
    arch = get_arch(arch_name)
    shape = arch.shape(shape_name)
    B = shape.params["batch"]
    f = _data_split(B, mesh)
    tshape = dataclasses.replace(shape, params={**shape.params,
                                                "batch": B // f})
    spec = build_lowering_spec(arch_name, shape_name, _trace_mesh(mesh),
                               n_layers_override=layers, variant=variant,
                               shape=tshape)
    tr = trace(spec)
    return Counts(argument_bytes=0, output_bytes=0, temp_bytes=tr.temp,
                  flops=tr.flops, hbm_bytes=tr.bytes,
                  collectives=traced_collectives(tr.calls, mesh, f > 1))


def lm_counts(arch_name: str, shape_name: str, mesh: Mesh,
              spec: LoweringSpec, variant: str = "baseline") -> Counts:
    """An LM cell's per-device counts: :func:`lm_sample` at 2 and 4
    layers, extrapolated linearly to the depth of ``spec`` (the cell's
    spec on ``mesh``), whose argument and output bytes it takes."""
    s2, s4 = (lm_sample(arch_name, shape_name, mesh, layers, variant)
              for layers in (2, 4))
    L = spec.args[0].cfg.n_layers

    def extrapolate(a2: float, a4: float) -> float:
        return a2 + (L - 2) * (a4 - a2) / 2

    stats = CollectiveStats()
    for op in s4.collectives.op_counts:
        stats.add(op, extrapolate(s2.collectives.op_bytes.get(op, 0.0),
                                  s4.collectives.op_bytes[op]),
                  extrapolate(s2.collectives.op_counts.get(op, 0),
                              s4.collectives.op_counts[op]))
    return Counts(
        argument_bytes=tree_shard_bytes(spec.args, spec.in_shardings, mesh),
        output_bytes=tree_shard_bytes(_outputs(spec), spec.out_shardings,
                                      mesh),
        temp_bytes=extrapolate(s2.temp_bytes, s4.temp_bytes),
        flops=extrapolate(s2.flops, s4.flops),
        hbm_bytes=extrapolate(s2.hbm_bytes, s4.hbm_bytes), collectives=stats)


def cell_counts(arch: str, shape: str, spec: LoweringSpec,
                variant: str = "baseline") -> Counts:
    """The per-device counts of the cell whose spec (on its mesh, at its
    depth) is ``spec``, the rules' collectives included."""
    if get_arch(arch).family == "lm":
        counts = lm_counts(arch, shape, spec.mesh, spec, variant)
    else:
        counts = count_spec(spec)
    counts.collectives.merge(rule_collectives(arch, shape, spec, spec.mesh))
    return counts


def run_cell(arch: str, shape: str, multi_pod: bool, verbose: bool = True,
             variant: str = "baseline") -> dict:
    """The cell's record on the production mesh; an LM cell always from
    its 2- and 4-layer traces (``--exact-lm``)."""
    mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
    n_dev = mesh.size
    t0 = time.perf_counter()
    spec = build_lowering_spec(arch, shape, mesh, variant=variant)
    t_lower = time.perf_counter() - t0
    counts = cell_counts(arch, shape, spec, variant)
    t_compile = time.perf_counter() - t0 - t_lower
    terms = roofline_from_counts(counts.flops, counts.hbm_bytes,
                                 counts.collectives, n_dev,
                                 model_flops=model_flops_for(arch, shape))
    rec = {
        "arch": arch,
        "shape": shape,
        "variant": variant,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "devices": n_dev,
        "lower_s": round(t_lower, 2),
        "compile_s": round(t_compile, 2),
        "memory": {
            "argument_bytes": int(counts.argument_bytes),
            "output_bytes": int(counts.output_bytes),
            "temp_bytes": int(counts.temp_bytes),
            "peak_bytes": int(counts.temp_bytes)
            + int(counts.argument_bytes),
        },
        "roofline": terms.summary(),
        "status": "ok",
    }
    if verbose:
        m = rec["memory"]
        r = rec["roofline"]
        print(f"[{arch} × {shape} @ {rec['mesh']}] traced ok "
              f"({rec['compile_s']}s)")
        print(f"  bytes/device: args {m['argument_bytes']/2**30:.2f}GiB "
              f"temps {m['temp_bytes']/2**30:.2f}GiB")
        print(f"  roofline: compute {r['compute_s']*1e3:.2f}ms | "
              f"memory {r['memory_s']*1e3:.2f}ms | "
              f"collective {r['collective_s']*1e3:.2f}ms "
              f"-> {r['bottleneck']}-bound")
        if r["model_flops"]:
            print(f"  useful-FLOPs ratio 6ND/traced: "
                  f"{r['useful_ratio']:.2f}")
    return rec


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--skip-repair-ir", action="store_true")
    ap.add_argument("--exact-lm", action="store_true",
                    help="the reference's exact LM costs; the port's only "
                         "behaviour (2- and 4-layer traces extrapolated)")
    ap.add_argument("--variant", type=str, default="baseline",
                    choices=("baseline", "opt"))
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args(argv)

    if args.all:
        cells = all_cells(include_repair_ir=not args.skip_repair_ir)
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    results = []
    failures = 0
    for mp in meshes:
        for arch, shape in cells:
            try:
                results.append(run_cell(arch, shape, mp,
                                        variant=args.variant))
            except Exception as e:  # a failure here is a framework bug
                failures += 1
                traceback.print_exc()
                results.append({"arch": arch, "shape": shape,
                                "mesh": "2x16x16" if mp else "16x16",
                                "status": f"FAIL: {type(e).__name__}: {e}"})
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {len(results)} records to {args.out}")
    ok = sum(1 for r in results if r.get("status") == "ok")
    print(f"\n{ok}/{len(results)} cells compiled")
    if failures:
        sys.exit(1)
    return results


if __name__ == "__main__":
    main()
