#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--seed 0] [--num-docs 20000]

Needs one NVIDIA card.  Phases, each printing its own lines; any failure
exits non-zero:

1. device  — the card's name, and its name and power limit from
   ``nvidia-smi``;
2. build   — the eight CUDA kernels compiled by ``nvcc`` into
   ``build_torch/`` (one process per source, started together), with
   ptxas reports;
3. index   — a Zipf collection (``zipf_corpus``: 20,000 docs, vocabulary
   20,000, mean length 120) compressed by the host Re-Pair and served by
   ``QueryServer(engine="cuda")``: paged index, probe and page-score
   operand packs and the block-max score directory on the card.  Then the
   codec tier is built for ``adaptive`` and for ``ef`` over the same
   index: per-codec list counts, bits per posting, build time;
3b. construct — the same postings built on the card by ``CudaBuilder``
   (every round's pair histogram counted by K4, ``pair_count``) and by
   ``TorchBuilder``, then on the host by ``HostBuilder``, all at the
   capped-counting configuration ``table_cap=4096``, 64 pairs per round:
   the three grammars must be bit-identical and every list must decode
   to its postings; K4 must launch once per round of the cuda build
   (counts zeroed just before it, read just after); a second cuda build
   under ``torch.profiler`` gives K4's device time summed over a build;
4. kernels — one routed K1 (``list_intersect``) batch of 8,192 lanes
   from the Zipf boolean workload's conjunctions plus edge lanes, one K2
   (``page_score``) batch of real score-directory entries, and one K3
   (``ef_next_geq``) batch of 8,192 lanes over the ``ef`` tier's store
   (the same conjunction probes plus edge lanes: bucket boundaries, heads,
   tails, past the tail, negative probes), each run by its kernel and its
   plain PyTorch version on the card: outputs must be exactly equal (and
   equal a numpy oracle); K4 on round 1's candidate table and pair stream
   (captured from the cuda build) and on an edge batch (sentinels,
   duplicates, a table of 1,037, invalid and negative slots; plus an
   all-invalid and a one-slot stream), against its plain version and
   numpy oracles, beside ``torch.unique`` + ``searchsorted`` on round 1
   (its library time); all timed with CUDA events and
   ``torch.profiler``;
5. serve   — 256 Zipf boolean queries at concurrency 64 (``search_many``)
   and 64 ranked top-10 queries (``search_topk_many``) through the
   server, once per codec: ``repair`` (K1 and K2 must launch),
   ``adaptive`` and ``ef`` (K3 must launch).  Launch counts are zeroed
   just before each codec's run and read just after, and every answer is
   checked against ``naive_eval`` / ``rank_oracle``.  Then (5b) each
   kernel's largest launch of the serve phase — for K1 and K3 the ranked
   membership round, about two million lanes — and every K2 launch of it
   is held against its plain version on the same inputs and timed the
   same way, beside one PyTorch ``searchsorted`` over the uncompressed
   postings that computes the same ``next_geq`` answers (the library time
   of K1 and K3); K3's largest launch's lane layout is printed (lists,
   lanes per list, the share of warps on one list and of lanes the masks
   settle);
6. profile — the ``repair`` and ``ef`` passes of phase 5 again, on fresh
   servers under ``torch.profiler``: each kernel's device time summed
   over its launches on the path (K1 and K2 in ``repair``, K3 in
   ``ef``); then a second, smaller ``repair`` pass: the device's busy and
   idle share and where its time went (phase 3b does the same for a
   second cuda build);
7. rebuild — ``QueryServer.rebuild`` of the running ``repair`` server
   with the cuda builder of phase 3b (K4 once per round, the grammar of
   3b again, the index version moved), then the same 256 boolean and 64
   ranked queries served from the rebuilt index (K1 and K2 must launch),
   every answer checked against ``naive_eval`` / ``rank_oracle``;
8. aux     — the entry points of K5-K8, counts zeroed just before and
   read just after (each must launch): K6 ``gap_decode`` at the
   reference's ``decode_bulk`` shape (16,384 x 4,096 gaps resampled from
   the index's d-gaps) and on every list in rows of 4,096 plus a row
   that wraps; K5 ``grammar_expand`` on every symbol of the served stream
   of at most 32 gaps, on terminals only and at half the depth; K7
   ``bucket_intersect`` on the first two terms of each boolean query,
   bucketized at ``kbits`` 7 and stacked, and on random unsorted rows with
   duplicates; K8 ``bitmap_and_count`` on a seeded pair at the repair-ir
   universe 2^25 and on the same query pairs as bitmaps.  Every output is
   checked against numpy (the lists decode to their postings, a sample of
   4,096 symbols against a stack walk, ``np.intersect1d`` per pair, the
   popcount), then each kernel is held against its plain version and
   timed beside its bound and its library yardstick (``torch.cumsum``,
   row-wise ``torch.searchsorted`` and ``torch.isin`` for K7's sorted
   rows, ``torch.isin`` for its random ones, ``torch.bitwise_and``; none
   for K5).
   The entry points run once more under ``torch.profiler`` for each
   kernel's device time summed over the phase.  Last,
   ``repro_torch.launch.quickstart`` runs on the card;
9. out-of-core — the phase-3 index served again, the same 256 boolean
   and 64 ranked queries, by ``QueryServer(engine="cuda", store="mmap",
   resident_pages=num_pages // 10)`` (18 of 183 pages): the stream lives
   in an mmap page store and reaches the card through the bounded
   resident pool.  Counts are zeroed just before and read just after:
   K1 must launch, every launch through the pool's slot table (its
   resident route).  Every answer must equal ``naive_eval`` /
   ``rank_oracle`` and phase 5's fully resident answers.
   ``ResidentSet.stats()`` (budget, faults, evictions, fault bytes,
   ``pool_grows``, hit rate, prefetch counters), q/s and p50/p95 are
   printed, and a fresh out-of-core pass runs under ``torch.profiler``
   for K1's resident path.  K1's largest resident launch of each
   workload is held against its plain version on the same pool and slot
   table, the pool's rows outside the launch's working set poisoned, and
   timed beside the fully resident route on the same lanes.
10. ingest — the phase-3 index served again by ``QueryServer(engine=
   "cuda")`` with the segment tier attached (``enable_ingest``: delta
   budget 256, fanout 4, the cuda builder at ``table_cap=4096``): 2,048
   new documents of the same law (``zipf_corpus`` at mean length 120,
   mapped onto the index's list ids) inserted in 8 rounds of 256, the
   stream ending in a ``flush``; after each round 64 boolean and 16
   top-10 queries, every answer checked against ``naive_eval`` /
   ``rank_oracle`` over the base plus the inserted documents.  Counts are
   zeroed just before the phase and read just after: K1, K2 and K4 must
   launch, every segment engine must sit on the card, and the stream must
   flush 8 times and compact at least twice.  Inserts per second, the
   flushes and compactions and their ms, the segments and each round's
   q/s and p50 / p95 are printed.
11. mesh — list-sharded serving of the phase-3 index, ``QueryServer(
   engine="cuda", mesh=Mesh(...))``: the grammar replicated, the stream
   list-partitioned, each shard's lanes run by K1 (a shard that owns
   every list on the engine's card through the engine's own pack), a max
   across the shards.  11a:
   ``Mesh([cuda:0])`` under ``repair`` and ``adaptive`` over phase 5's
   256 boolean and 64 top-10 queries, then 256 conjunctions through
   ``and_batch``; 11b: the boolean queries (as planned, then svs forced)
   and the conjunctions on ``Mesh([cuda:0, cuda:0])``, each shard's
   lists, stream length and table bytes printed; 11c: phase 10's stream
   under ``Mesh([cuda:0])``, cut to its first 2 rounds of 256 documents.
   Launch and dispatch counts are zeroed just before each pass and read
   just after: the merged rounds must take the sharded dispatch and
   launch K1 at least once per shard per dispatch, K2 serve the ranked
   decodes, K3 the EF lanes under ``adaptive``, K1 the conjunctions'
   ``_probe_dev`` (replicated, as in ``repro``), K4 the flushes; every
   segment engine must be sharded.  Every answer equals phase 5's
   unsharded answers and the oracles, and the largest sharded round's
   lanes, run again through the sharded route, equal the plain flat
   program over the whole index on the same lanes.
12. lm — the LM serving tier (``repro_torch.serve.DecodeEngine`` over a
   ``repro_torch.models.transformer.Transformer``; no kernel of the port
   runs there, as no Pallas kernel runs in ``repro``'s).  12a: the five
   LM archs' smoke configs on ``cuda:0`` against the same parameters on
   the CPU (``init_params`` from a seeded CPU generator, then ``.to``),
   6 requests each on the launcher's engine (4 lanes, 64 slots, 16 new
   tokens), teacher-forced on the CPU run's tokens: the same inputs at
   every prefill and step, logits within 2e-2, the same finished
   requests.  12b: yi-6b (arXiv:2403.04652) at full width cut to 2
   layers (870,338,560 parameters), a 64-token prompt and 8 decode ticks,
   card against CPU, logits within 2e-2 × max|logit| and the argmax
   equal wherever the CPU's top-2 margin exceeds that.  12c: yi-6b at
   full width and depth (32 layers, 6,061,035,520 parameters, 12.12 GB in
   bf16) initialised on the card from a seeded CUDA generator; gates:
   ``prefill``'s last logits == ``forward``'s there (2e-2), one decode
   step after a 63-token prefill == ``forward`` at position 63 (within
   2e-2 × max|logit|), no NaN; then 16 requests with prompts of 64-512
   tokens through ``DecodeEngine(max_batch=8, s_cache=2048,
   max_new_tokens=32)``, every request finishing: tokens/s, prefill ms by
   prompt length, decode ms per tick, ``max_memory_allocated``, the
   device busy share of a profiled decode step, and that step's bytes
   against the HBM bound, printed on the ``lm`` JSON line.
13. train — the training tier (``repro_torch.train``: AdamW as plain
   tensor code, checkpoints in ``repro``'s format, the ``Trainer``; no
   kernel of the port runs there, as no Pallas kernel runs in ``repro``'s
   training).  13a: the five LM archs' smoke configs, 3 ``Trainer`` steps
   on ``cuda:0`` against the same parameters on the CPU (a seeded CPU
   generator, then ``.to``) on the same pipeline: loss and global grad
   norm of each step within 2e-2 relative, parameters after the last step
   within 2e-2 × the leaf's max |p| (an element whose last gradients
   differ in sign, both inside the gradients' tolerance, within that plus
   2 · lr: Adam's first steps are sign-like).  13b: yi-6b at full width
   cut to 2 layers (870,338,560 parameters): one step at seq 128, batch 1,
   card against CPU under 13a's gates and its gradients within 2e-2 × the
   leaf's max |g|; then 6 timed steps on the card at ``train_4k``'s
   sequence length 4096, batch 1: step ms, tokens/s,
   ``max_memory_allocated``, the device busy share of one profiled step
   and the model FLOPs per step (formula printed) against the dense bf16
   peak.  13c: crash-exact resume on the card under
   ``torch.use_deterministic_algorithms(True)``: yi-6b's smoke config 6
   steps straight against 3 steps, a save, a fresh ``Trainer`` that
   restores, 3 more — losses and every parameter and optimizer tensor
   equal bit for bit.  13d: ``launch/train.py --smoke --arch yi-6b
   --steps 20`` on the card; the trained model's loss on the first step's
   batch must be below that step's.  13e: ``launch/web_graph.py`` on the
   card prints what it prints on the CPU, and GCN logits on the same
   parameters agree within 1e-5.  Printed on the ``train`` JSON line.
14. distribution — the model rules of distribution (``repro_torch.
   distributed``: one process, every mesh of repeated ``cuda:0`` entries,
   a ``shard_map`` body run once per coordinate; no kernel of the port
   runs there, as no Pallas kernel runs in ``repro``'s).  14a: the smoke
   configs of granite-moe and phi3.5-moe with the mesh wired into
   ``LMConfig`` (granite TP inside the experts at (data 2, model 2),
   expert parallel at (1, 5), padded at (2, 2); phi expert parallel at
   (2, 2), TP inside and padded at (1, 8)) on the card against the same
   mesh of CPU entries: forward logits and aux within 2e-2, the engine
   teacher-forced as 12a within 2e-2 × max|logit|.  14b: both at full
   width cut to 2 layers over a model axis of 16 (granite TP inside, phi
   expert parallel), card against CPU within 2e-2 × max|logit|; granite's
   expert-parallel (model 8) and TP-inside (model 16) layouts against the
   unsharded model on the card within that gate, the tokens whose kept
   experts differ (a near tie flipped by the bf16 order of the sums)
   named and left out.  14c: granite at full width and depth (32 layers,
   3.38 B parameters) over (data 2, model 16): ``prefill`` == ``forward``
   and one decode step == ``forward`` at position 63, both dropless (at
   capacity factor 1.25 a token's drops depend on its batch; that gap is
   printed), then requests through ``DecodeEngine`` as 12c, meshed and
   unsharded, cut to 8 requests of 12 new tokens (``DIST_SERVE``).  14d: ``compressed_psum_with_feedback`` over a data
   axis of 2 on yi-6b's leaves of one layer plus embed and unembed (0.70
   B elements a shard), 3 carried steps: card == CPU bit for bit, out +
   Σ new_e == Σ target within float32 rounding, ms per call.  14e:
   ``pipeline_apply`` over 4 stages (d 4096, 32 layers, batch 64, 8
   microbatches): float32 forward within 1e-5 of ``mlp_reference`` on
   the card, float64 forward and gradients within 1e-5 / 1e-4 (float32
   gradients printed: relu kinks make them ill-posed at this depth), the
   float32 fwd+bwd ms beside the reference's.  Printed on the
   ``distribution`` JSON line.
15. dryrun — the dry run (``repro_torch.launch.dryrun``: every cell's
   step traced on the meta device; no kernel of the port runs there, as
   none runs in ``repro``'s).  15a: all 43 cells on both production
   meshes (86 records, meta entries, nothing allocated), each ``"ok"``;
   per family its largest per-device ``peak_bytes`` and that cell's
   bottleneck; every cell whose argument bytes alone pass the card's 80
   GB named.  15b: the dry run against the card's own run of the same
   spec on a (1, 1) mesh of ``cuda:0``: yi-6b's ``lm_train_spec`` at full
   width, 2 layers, seq 4096, batch 1 (13b's step), and one decode tick
   of 12c's shape (32 layers, batch 8, ``s_cache`` 2048); gates: the
   traced FLOPs equal ``FlopCounterMode``'s count of the card's run, and
   the argument bytes the bytes of the real arguments, exactly; printed:
   predicted ``peak_bytes`` against ``max_memory_allocated`` (above what
   was allocated before), the compute and memory terms against the
   measured step or tick.  15c: ``CheckpointManager.restore(shardings=)``
   of a saved yi-6b smoke state onto (2, 2) and (1, 4) meshes of
   repeated ``cuda:0``: every shard equals ``shard_tensor`` of the saved
   tensor bit for bit; and ``launch/train.py --arch yi-6b`` (production
   mode) returns an ``"ok"`` record.  Printed on the ``dryrun`` JSON
   line.

The last lines are the ``lm`` JSON line, the ``train`` JSON line, the
``distribution`` JSON line, the ``dryrun`` JSON line, the ``kernels``
JSON line (per kernel: launches on its
path — K1 and K2 while serving ``repair``, K3 while serving ``ef``, K4 in
the cuda build, K5-K8 in phase 8 — times and bounds at its main launch,
``path_ms``, its device time summed over the launches of its path, with
every batch it was held on under ``shapes``, K1's resident route of
phase 9 among them, each with the bytes and operations of its bound),
the ``nvidia-smi`` line, and ``{"ok": true, "device": {...}}``.  A
kernel's bound counts what its function needs on the batch's inputs
(``k1_traffic`` ... ``k7_traffic``), the same for any kernel.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, and the non-tensor
#: float32 rate, the table's only scalar-ALU rate, used for int32 work
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12

BOOLEAN_QUERIES, CONCURRENCY, RANKED_QUERIES, TOPK = 256, 64, 64, 10
K1_LANES, K2_ENTRIES, K3_LANES = 8192, 512, 8192
TIER_MODES = ("adaptive", "ef")
#: the device builders' [CN07] capped-counting configuration (the one the
#: reference gives its pallas builder on real corpora)
BUILD_TABLE_CAP = 4096
#: phase 8: the reference's decode_bulk shape (rows, gap columns) and
#: document universe of repair-ir (src/repro/configs/repair_ir.py:49, :35),
#: and the bucket width of K7's layout
DECODE_BULK = (1 << 14, 1 << 12)
BITMAP_UNIVERSE = 1 << 25
AUX_KBITS = 7
AUX_KERNELS = ("grammar_expand", "gap_decode", "bucket_intersect",
               "bitmap_and")
#: phase 10: documents streamed into the served index, in rounds, the
#: queries checked after each round, and the segment tier's defaults
#: (``REPRO_DELTA_BUDGET``, ``REPRO_COMPACT_FANOUT``)
INGEST_DOCS, INGEST_ROUNDS = 2048, 8
INGEST_BOOLEAN, INGEST_RANKED = 64, 16
INGEST_BUDGET, INGEST_FANOUT = 256, 4
#: phase 11: conjunctions sent through ``and_batch`` per mesh server, and
#: the rounds of phase 10's stream run again under the 1-shard mesh
MESH_PAIRS, MESH_INGEST_ROUNDS = 256, 2
#: phase 12: the LM archs of 12a, the logit tolerance, and 12c's
#: workload: requests, prompt lengths, the engine's lanes, cache slots and
#: new tokens, and the decode step profiled (all lanes live by then)
LM_ARCHS = ("qwen3-32b", "yi-6b", "minicpm3-4b", "granite-moe-3b-a800m",
            "phi3.5-moe-42b-a6.6b")
LM_TOL = 2e-2
LM_REQUESTS, LM_PROMPTS = 16, (64, 512)
LM_SERVE = dict(max_batch=8, s_cache=2048, max_new_tokens=32)
LM_PROFILE_STEP = 8
#: phase 13: the tolerance of card against CPU (loss, grad norm, and
#: parameters × the leaf's max |p|), 13a's steps, the optimizer of 13a and
#: 13b, and 13b's timed steps at train_4k's sequence length; the H100 SXM
#: dense bf16 peak (NVIDIA data sheet) for the model-FLOPs share
TRAIN_TOL = 2e-2
TRAIN_STEPS = 3
TRAIN_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
TRAIN_SEQ, TRAIN_TIMED = 4096, 6
H100_BF16_FLOPS = 989e12
#: phase 14: the MoE archs run over a mesh; 14a's smoke meshes per arch
#: ((data, model), ep_pad): granite's 5 experts TP inside at model 2,
#: expert parallel at 5, padded at 2; phi's 4 experts expert parallel at 2,
#: TP inside and padded at 8 (its smoke d_ff of 64 does not split 5 ways,
#: and the reference's shard_map refuses that too); 14b's production model
#: axis, its layers and tokens; 14c's mesh and requests; 14d's data axis
#: and carried steps; 14e's GPipe (stages, layers, width, batch,
#: microbatches)
DIST_ARCHS = ("granite-moe-3b-a800m", "phi3.5-moe-42b-a6.6b")
DIST_SMOKE = {DIST_ARCHS[0]: (((2, 2), False), ((1, 5), False),
                              ((2, 2), True)),
              DIST_ARCHS[1]: (((2, 2), False), ((1, 8), False),
                              ((1, 8), True))}
DIST_TP, DIST_LAYERS, DIST_TOKENS = 16, 2, 128
#: 14c's meshed decode tick is host-bound (32 coordinates x 32 layers of
#: eager ops, about 2.4 s a tick on the H100), so its serve run is cut from
#: 12c's 16 requests x 32 new tokens to 8 x 12, the unsharded run beside
#: it to the same
DIST_MESH, DIST_SERVE = (2, 16), dict(requests=8, max_new_tokens=12)
PSUM_SHARDS, PSUM_STEPS = 2, 3
GPIPE = dict(stages=4, layers=32, d=4096, batch=64, micro=8)


#: phase 15: the card's memory, against which 15a names the cells whose
#: arguments alone do not fit one card; 15b's timed train steps and
#: decode ticks
CARD_BYTES = 80e9
DRY_STEPS, DRY_TICKS = 3, 10


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _device_ms(fn, reps: int) -> tuple[float, float]:
    """Per call of ``fn``: the device time of the kernels it launched
    (``torch.profiler``'s CUDA activity, summed over all kernels) and the
    wall time between CUDA events around the calls, which also counts the
    host's launch overhead.  Both in ms, after two warm-up calls.  A
    profiler session that records no device time is run once more; if it
    is empty again, the CUDA events give both numbers, and a line says
    so."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    for attempt in (1, 2):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            start.record()
            for _ in range(reps):
                fn()
            stop.record()
            torch.cuda.synchronize()
        wall = start.elapsed_time(stop) / reps
        dev_us = sum(getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0))
                     for e in prof.key_averages())
        if dev_us > 0:
            return dev_us / reps / 1e3, wall
        print(f"[timing] torch.profiler recorded no device time (session "
              f"{attempt} of 2, {len(prof.events())} events: "
              f"{sorted({e.key[:40] for e in prof.key_averages()})})")
    print(f"[timing] CUDA events give this call's device time: "
          f"{wall:.5f} ms")
    return wall, wall


def _profile(fn) -> dict:
    """Run ``fn`` once under ``torch.profiler`` and ``cProfile`` at once:
    its wall ms, the device-busy ms (every kernel and copy, summed), the
    number of device activities, the five largest device-time entries,
    and the eight host functions with the most self time (both profilers
    slow the host, so read these as shares)."""
    import cProfile
    import pstats
    import torch
    from torch.profiler import ProfilerActivity, profile
    host = cProfile.Profile()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        host.enable()
        fn()
        torch.cuda.synchronize()
        host.disable()
    wall = (time.perf_counter() - t0) * 1e3
    dev = [(e.key, getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0.0)) / 1e3,
            e.count) for e in prof.key_averages()]
    dev = sorted((d for d in dev if d[1] > 0), key=lambda d: -d[1])
    stats = pstats.Stats(host).stats
    top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:8]
    return dict(wall=wall, busy=sum(ms for _, ms, _ in dev),
                events=sum(n for _, _, n in dev), entries=dev,
                device=[(k, ms) for k, ms, _ in dev[:5]],
                host=[(f"{Path(f).name}:{line}({fn})", tt * 1e3)
                      for (f, line, fn), (_, _, tt, _, _) in top])


def _print_profile(tag: str, what: str, prof: dict) -> None:
    busy = 100 * prof["busy"] / prof["wall"]
    print(f"[{tag}] {what}, profilers on: wall {prof['wall']:.1f} ms, "
          f"device busy {prof['busy']:.1f} ms ({busy:.2f}%), idle "
          f"{100 - busy:.2f}%, {prof['events']} device activities")
    print(f"[{tag}] device: " + "; ".join(
        f"{k[:70]} {ms:.2f} ms" for k, ms in prof["device"]))
    print(f"[{tag}] host self time: " + "; ".join(
        f"{k} {ms:.0f} ms" for k, ms in prof["host"]))


def _globals(name: str) -> tuple[str, ...]:
    """The ``__global__`` functions of a kernel's source: the names its
    launches carry in a profile."""
    src = (ROOT / "src" / "repro_torch" / "csrc" / f"{name}.cu").read_text()
    return tuple(re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(",
        src))


def _profile_path(fn, names) -> tuple[dict, dict]:
    """``_profile(fn)`` and, for each kernel in ``names``, its device ms and
    launches summed over the profile's entries of its ``__global__``
    functions, from a session that recorded every launch of it
    (``kernels.LAUNCHES`` counts them).  The profiler has recorded
    launches but no kernels in some sessions, so ``fn`` (which must be
    repeatable) runs again, up to six sessions, for the kernels still
    missing; a kernel never recorded whole is left out of the result
    (``_kernel_row`` then reports its path as not recorded)."""
    from repro_torch import kernels as KR
    path, missing = {}, list(names)
    for attempt in range(1, 7):
        before = dict(KR.LAUNCHES)
        prof = _profile(fn)
        for name in missing:
            pat = re.compile(r"\b(" + "|".join(_globals(name)) + r")\b")
            hits = [(ms, n) for key, ms, n in prof["entries"]
                    if pat.search(key)]
            ms, n = sum(h[0] for h in hits), sum(h[1] for h in hits)
            if n and n == KR.LAUNCHES[name] - before[name]:
                path[name] = (ms, n)
        missing = [n for n in names if n not in path]
        if not missing:
            break
        print(f"[timing] profile session {attempt} of 6 did not record "
              f"every launch of {missing}")
    return prof, path


def _print_path(tag: str, what: str, paths: dict, names) -> None:
    print(f"[{tag}] device time of each kernel summed over {what}: "
          + "; ".join(f"{name} {paths[name][0]:.5f} ms in "
                      f"{paths[name][1]} launches" if name in paths else
                      f"{name} not recorded" for name in names))


def _bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _grammar_nodes(tables, T, roots):
    """Unique symbols of the parse trees under ``roots`` (int64 tensor):
    what a positional descent over every element of those symbols reads."""
    import torch
    seen, frontier = [], torch.unique(roots)
    while frontier.numel():
        seen.append(frontier)
        rules = frontier[frontier >= T]
        frontier = torch.unique(torch.cat(
            [tables["sym_left"][rules], tables["sym_right"][rules]]).long())
    nodes = torch.unique(torch.cat(seen))
    return int((nodes >= T).sum()), int((nodes < T).sum())


def k1_traffic(lanes, tables, statics, page=None) -> tuple[float, float]:
    """Bytes and int32 operations one K1 launch needs on these lanes: each
    input read once (lane arrays, per-list span ends and lasts, the union
    of stream positions the skip loops read, the halting symbols, the
    grammar nodes the descents visit), the output written once.  The
    stream is read from the whole paged ``tables``; with ``page`` (the
    resident route) each stream page read also costs its slot-table entry
    (4 bytes per distinct page)."""
    import torch
    lids, xs, pos0, s0 = lanes
    lid = lids.long()
    end = tables["starts"][lid + 1]
    live = xs <= tables["lasts"][lid]
    pos, s = pos0.clone(), s0.clone()
    stream = tables["c_sums_pg"].reshape(-1)
    steps = torch.zeros_like(pos)
    go = live & (pos < end)
    for _ in range(statics["max_scan"]):
        if not bool(go.any()):
            break
        ps = stream[pos.clamp(0, stream.numel() - 1).long()]
        take = go & (s + ps < xs)
        steps += go.int()
        pos = torch.where(take, pos + 1, pos)
        s = torch.where(take, s + ps, s)
        go = take & (pos < end)
    # union of the scanned intervals [pos0, pos0 + steps)
    n = stream.numel()
    diff = torch.zeros(n + 1, dtype=torch.int64, device=lids.device)
    has = steps > 0
    diff.index_add_(0, pos0[has].long(), torch.ones_like(pos0[has].long()))
    diff.index_add_(0, (pos0 + steps)[has].long(),
                    -torch.ones_like(pos0[has].long()))
    in_scan = diff.cumsum(0)[:n] > 0
    scanned = int(in_scan.sum())
    desc = live & (s < xs) & (pos < end)
    syms = tables["c_syms_pg"].reshape(-1)[pos[desc].long()]
    T = statics["T"]
    sym, s_d, x_d = syms.clone(), s[desc].clone(), xs[desc]
    visited, depth_steps = [sym.long()], 0
    for _ in range(statics["max_depth"]):
        rule = sym >= T
        if not bool(rule.any()):
            break
        depth_steps += int(rule.sum())
        left = tables["sym_left"][sym.clamp(min=0).long()]
        ls = tables["sym_sum"][left.clamp(min=0).long()]
        go_left = s_d + ls >= x_d
        right = tables["sym_right"][sym.clamp(min=0).long()]
        sym = torch.where(rule, torch.where(go_left, left, right), sym)
        s_d = torch.where(rule & ~go_left, s_d + ls, s_d)
        visited.append(sym[rule].long())
    nodes = torch.unique(torch.cat(visited))
    n_rules = int((nodes >= T).sum())
    q = lids.numel()
    nbytes = (16 * q + 4 * q + 8 * int(torch.unique(lid).numel())
              + 4 * scanned + 4 * int(torch.unique(pos[desc]).numel())
              + 12 * n_rules + 4 * int((nodes < T).sum()))
    ops = 4 * q + 5 * int(steps.sum()) + 6 * depth_steps
    if page is not None:
        read = torch.cat([in_scan.nonzero().squeeze(1), pos[desc].long()])
        nbytes += 4 * int(torch.unique(read // page).numel())
        ops += int(steps.sum()) + int(desc.sum())
    return float(nbytes), float(ops)


def k2_traffic(meta, tables, statics, b_pad: int) -> tuple[float, float]:
    """Bytes one K2 launch needs on these entries — the metadata, each
    live entry's window of lengths, sums and symbols, the grammar nodes
    under the window's symbols (every element is decoded), and the whole
    (Q, b_pad) output written once — and its int32 operations, estimated
    from above (full-depth descents)."""
    import math
    import torch
    pages, slo, nsym, base, head, cnt = meta
    live = cnt > 0
    page = tables["c_syms_pg"].shape[1]
    flat = tables["c_syms_pg"].reshape(-1)
    starts = (pages.long() * page + slo.long())[live]
    lens = nsym.long()[live]
    idx = torch.repeat_interleave(starts, lens) + (
        torch.arange(int(lens.sum()), device=pages.device)
        - torch.repeat_interleave(torch.cumsum(lens, 0) - lens, lens))
    syms = flat[idx].long()
    n_rules, n_terms = _grammar_nodes(tables, statics["T"], syms)
    q = pages.numel()
    window = int(lens.sum())
    elems = int(cnt.long()[live].sum())
    nbytes = 24 * q + 12 * window + 16 * n_rules + 4 * n_terms \
        + 4 * q * b_pad
    ops = 4 * window + elems * (3 * math.log2(max(page, 2))
                                + 6 * statics["max_depth"]) + q * b_pad
    return float(nbytes), float(ops)


def k3_traffic(lids, xs, pack) -> tuple[float, float]:
    """Bytes and int32 operations the function of one K3 launch needs on
    these lanes, the same for any kernel: the reference's algorithm
    (``core/ef.py`` ``ef_next_geq_np``) replayed with its loops stopped at
    their fixed points (int64 here: no offset of this store wraps int32).
    Bytes: each input it touches read once — the lane arrays, the
    directory entries of the probed lists, and the union of select
    samples, high-bits words and low-bits words the lanes reach — and the
    output written once.  Operations per lane: 6 for the masks; on a lane
    the masks do not settle, per select 6 for each sample-bisection trip
    up to its fixed point, 3 for each word of the selected sample page
    popcounted up to the word that holds the answer, 4 for the in-word
    select and 4 for its arithmetic; 8 for each bucket-bisection trip and
    10 for the answer."""
    import torch
    from repro_torch.core.ef import popc
    tab = {k: v.long() for k, v in pack.items() if k != "hi_words"}
    hi_words = pack["hi_words"]
    li, x = lids.long(), xs.long()
    act = (tab["n"][li] > 0) & (x <= tab["lasts"][li]) \
        & (x > tab["firsts"][li])
    q, ops = lids.numel(), 6 * lids.numel()
    dir_bytes = 12 * int(torch.unique(li).numel()) \
        + 16 * int(torch.unique(li[act]).numel())
    li, x = li[act], x[act]
    l = tab["lbits"][li]
    hx, xlo = x >> l, x & ((1 << l) - 1)
    hw0 = tab["hi_word"][li]
    hp0, hp1 = hw0 // 8, tab["hi_word"][li + 1] // 8
    rank, npg = tab["rank_pg"], tab["rank_pg"].numel()
    nw = hi_words.numel()
    touched = {"rank": [], "hi": [], "lo": []}

    def select(k, ones):
        nonlocal ops
        r0i = hp0.clamp(max=npg - 1)
        touched["rank"].append(r0i)
        r0 = rank[r0i]
        lo, hi = hp0.clone(), torch.maximum(hp1 - 1, hp0)
        live = lo != hi
        for _ in range(32):
            if not bool(live.any()):
                break
            ops += 6 * int(live.sum())
            mid = (lo + hi + 1) >> 1
            mi = mid.clamp(max=npg - 1)
            touched["rank"].append(mi[live])
            rm = rank[mi]
            cnt = (rm - r0) if ones else (mid - hp0) * 256 - (rm - r0)
            go = cnt <= k
            lo = torch.where(live & go, mid, lo)
            hi = torch.where(live, torch.maximum(torch.where(go, hi, mid - 1),
                                                 lo), hi)
            live = lo != hi
        rpi = lo.clamp(max=npg - 1)
        touched["rank"].append(rpi)
        rp = rank[rpi]
        k_rel = k - ((rp - r0) if ones else (lo - hp0) * 256 - (rp - r0))
        w0 = lo * 8
        cum = torch.zeros_like(k_rel)
        word_sel, k_in = w0.clone(), k_rel.clone()
        found = torch.zeros_like(live)
        for j in range(8):
            scan = ~found
            if not bool(scan.any()):
                break
            ops += 3 * int(scan.sum())
            wi = (w0 + j).clamp(max=nw - 1)
            touched["hi"].append(wi[scan])
            c = popc(hi_words[wi]).long()
            c = c if ones else 32 - c
            take = scan & (cum + c > k_rel)
            word_sel = torch.where(take, w0 + j, word_sel)
            k_in = torch.where(take, k_rel - cum, k_in)
            found |= take
            cum = cum + c
        w = hi_words[word_sel.clamp(max=nw - 1)].long() & 0xFFFFFFFF
        bits = (w[:, None] >> torch.arange(32, device=w.device)) & 1
        isb = (bits == int(ones)).long()
        hit = (isb.cumsum(1) == (k_in + 1)[:, None]) & (isb == 1)
        bit = torch.where(hit.any(1), hit.int().argmax(1), 0)
        ops += 8 * k.numel()
        return (word_sel - hw0) * 32 + bit

    nlw = pack["lo_words"].numel()
    lw = pack["lo_words"].long() & 0xFFFFFFFF

    def low(gbit):
        w = (gbit >> 5).clamp(max=nlw - 2)
        touched["lo"].extend([w, (w + 1)[(gbit & 31) != 0]])

    i1 = select(hx, False) - hx
    i0 = torch.where(hx == 0, 0, select((hx - 1).clamp(min=0), False)
                     - (hx - 1))
    i1m = torch.minimum(i1.clamp(min=0), (tab["n"][li] - 1).clamp(min=0))
    select(i1m, True)
    gb0 = tab["lo_word"][li] * 32
    lo_b, hi_b = i0.clone(), i1.clone()
    for _ in range(32):
        live = lo_b < hi_b
        if not bool(live.any()):
            break
        ops += 8 * int(live.sum())
        mid = (lo_b + hi_b) >> 1
        gbit = gb0 + mid * l
        low(gbit[live])
        off = gbit & 31
        w = (gbit >> 5).clamp(max=nlw - 2)
        hip = torch.where(off == 0, 0, (lw[w + 1] << (32 - off)) & 0xFFFFFFFF)
        ge = ((lw[w] >> off) | hip) & ((1 << l) - 1) >= xlo
        hi_b = torch.where(live & ge, mid, hi_b)
        lo_b = torch.where(live & ~ge, mid + 1, lo_b)
    found = lo_b < i1
    low(gb0 + torch.where(found, lo_b, i1m) * l)
    ops += 10 * int(li.numel())
    uniq = sum(int(torch.unique(torch.cat(v)).numel()) if v else 0
               for v in touched.values())
    return float(12 * q + dir_bytes + 4 * uniq), float(ops)


def k3_layout(lids, xs, pack) -> dict:
    """How one K3 launch's lanes fall on the store's lists: the distinct
    lists, lanes per list (min / median / max), runs of consecutive lanes
    on one list, the share of 32-lane warps whose lanes all probe one
    list, and the share of lanes the masks settle (an empty list, x at or
    before the head, x past the tail)."""
    import torch
    li, x = lids.long(), xs.long()
    n, first, last = (pack[k].long()[li] for k in ("n", "firsts", "lasts"))
    settled = (n == 0) | (x <= first) | (x > last)
    counts = torch.unique(li, return_counts=True)[1].sort().values
    warps = li[:li.numel() // 32 * 32].view(-1, 32)
    return dict(lanes=int(li.numel()), lists=int(counts.numel()),
                lanes_per_list=[int(counts[0]),
                                int(counts[counts.numel() // 2]),
                                int(counts[-1])],
                runs=int((li[1:] != li[:-1]).sum()) + 1,
                one_list_warps=float((warps == warps[:, :1]).all(1)
                                     .float().mean()),
                settled=float(settled.float().mean()))


def k4_traffic(ca, pa, vm) -> tuple[float, float]:
    """Bytes and int32 operations one K4 launch needs on this candidate
    table and pair stream: each input read once (two int32 per candidate,
    three per slot), the counts written once; per slot a validity test,
    and per valid slot its 64-bit key (3 operations) and a binary search
    of ``ceil(log2 K)`` steps (2 operations each) into the candidate
    table, plus the match test and the count."""
    import math
    K, N = int(ca.numel()), int(pa.numel())
    valid = int((vm != 0).sum())
    steps = math.ceil(math.log2(max(K, 2)))
    return float(12 * K + 12 * N), float(N + valid * (5 + 2 * steps) + K)


def _pair_count_np(ca, cb, pa, pb, vm):
    """numpy counts of the candidate pairs over the valid slots: one
    ``np.unique`` of the slots' pairs, then a lookup per candidate."""
    import numpy as np
    keys = lambda a, b: a.astype(np.int64) * 2**32 + (b.astype(np.int64)
                                                       & 0xFFFFFFFF)
    uniq, cnt = np.unique(keys(pa, pb)[vm != 0], return_counts=True)
    uniq = np.append(uniq, np.iinfo(np.int64).max)   # past every real key
    cnt = np.append(cnt, 0)
    k = keys(ca, cb)
    pos = np.searchsorted(uniq, k)
    return np.where((uniq[pos] == k) & (ca >= 0), cnt[pos], 0
                    ).astype(np.int32)


def _unique_counts(ca, cb, pa, pb, vm):
    """The library yardstick of K4: the valid slots' 64-bit pair keys
    counted by one ``torch.unique(..., return_counts=True)``, each
    candidate's count read back with one ``torch.searchsorted``.  Timed
    beside the kernel, used nowhere in the port."""
    import torch
    from repro_torch.kernels.pair_count import pair_keys
    uniq, cnt = torch.unique(pair_keys(pa, pb)[vm != 0], return_counts=True)
    k = pair_keys(ca, cb)
    pos = torch.searchsorted(uniq, k).clamp(max=max(uniq.numel() - 1, 0))
    hit = (uniq[pos] == k) & (ca >= 0)
    return torch.where(hit, cnt[pos], 0).to(torch.int32)


def _k4_edge(rng):
    """K4's edge batch: K = 1,037 candidates (no multiple of 128 or 512)
    with ``-1`` sentinels, a sentinel left beside a real right, duplicate
    candidates, and candidates absent from the stream, over a
    300,000-slot stream with invalid slots and ``-1`` symbols; plus an
    all-invalid stream and a one-slot stream (run unheld)."""
    import numpy as np
    n = 300_000
    seq = rng.integers(0, 60, n + 1).astype(np.int32)
    seq[:40] = -1
    active = rng.random(n + 1) < 0.8
    ca = rng.integers(0, 60, 1037).astype(np.int32)
    cb = rng.integers(0, 60, 1037).astype(np.int32)
    ca[100:300] = -1
    ca[300:310] = -1
    cb[300:310] = seq[50:60]
    ca[400:600], cb[400:600] = ca[:200], cb[:200]        # duplicates
    ca[600:650] = 70 + np.arange(50)                     # absent pairs
    return seq, active, ca, cb


def _decode_check(res, lists) -> None:
    """Every list of ``res`` decodes to its postings: the whole stream is
    expanded level by level with numpy (each rule symbol replaced by its
    two children) and compared with the lists' heads and d-gaps."""
    import numpy as np
    g = res.grammar
    syms = res.seq.astype(np.int64)
    owner = np.repeat(np.arange(res.num_lists), np.diff(res.starts))
    while (syms >= g.num_terminals).any():
        rule = syms >= g.num_terminals
        reps = np.where(rule, 2, 1)
        at = np.cumsum(reps) - reps
        kids = g.rules[syms[rule] - g.num_terminals]
        syms, owner = np.repeat(syms, reps), np.repeat(owner, reps)
        syms[at[rule]], syms[at[rule] + 1] = kids[:, 0], kids[:, 1]
    want = np.concatenate([np.diff(np.asarray(l, np.int64)) for l in lists])
    if not (np.array_equal(syms, want)
            and np.array_equal(np.bincount(owner, minlength=len(lists)),
                               [len(l) - 1 for l in lists])
            and np.array_equal(res.first_values, [l[0] for l in lists])):
        raise SystemExit("[construct] a decoded list differs from its "
                         "postings")


def _same_grammar(a, b) -> bool:
    import numpy as np
    return (a.grammar.num_terminals == b.grammar.num_terminals
            and all(np.array_equal(x, y) for x, y in (
                (a.grammar.rules, b.grammar.rules),
                (a.grammar.sums, b.grammar.sums),
                (a.grammar.lengths, b.grammar.lengths),
                (a.grammar.depths, b.grammar.depths), (a.seq, b.seq),
                (a.starts, b.starts), (a.first_values, b.first_values))))


def _construct(lists) -> dict:
    """Build ``lists`` with the cuda, torch and host builders at the
    capped-counting configuration; the launch counts are zeroed just
    before the cuda build and read just after, and round 1's K4 inputs
    are kept.  Checks the three grammars bit-identical and every list
    decoded."""
    import torch
    from repro_torch import kernels as KR
    from repro_torch.build import CudaBuilder, HostBuilder, TorchBuilder
    from repro_torch.build import cuda_builder
    cfg = dict(table_cap=BUILD_TABLE_CAP, pairs_per_round=64)
    bld = CudaBuilder(device="cuda", **cfg)
    first = []
    real = cuda_builder.pair_count

    def recording(*a):
        if not first:
            first.append(tuple(t.clone() for t in a))
        return real(*a)

    cuda_builder.pair_count = recording
    try:
        KR.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = bld.build_grammar(lists)
        t_cuda = time.perf_counter() - t0
        launches = dict(KR.LAUNCHES)
    finally:
        cuda_builder.pair_count = real
    tb = TorchBuilder(device="cuda", **cfg)
    t0 = time.perf_counter()
    res_torch = tb.build_grammar(lists)
    t_torch = time.perf_counter() - t0
    t0 = time.perf_counter()
    res_host = HostBuilder(**cfg).build_grammar(lists)
    t_host = time.perf_counter() - t0
    if not (_same_grammar(res, res_torch) and _same_grammar(res, res_host)):
        raise SystemExit("[construct] the cuda, torch and host grammars "
                         "differ")
    for r in (res, res_torch, res_host):
        _decode_check(r, lists)
    if launches["pair_count"] != bld.stats["rounds"] \
            or launches["pair_count"] == 0:
        raise SystemExit(f"[construct] pair_count launched "
                         f"{launches['pair_count']} times in "
                         f"{bld.stats['rounds']} rounds")
    if tb.stats != bld.stats:
        raise SystemExit(f"[construct] torch rounds {tb.stats} differ from "
                         f"cuda rounds {bld.stats}")
    return dict(builder=bld, res=res, launches=launches, round1=first[0],
                t_cuda=t_cuda, t_torch=t_torch, t_host=t_host,
                stats=bld.stats)


def _k1_lanes(lists, universe, lengths, seed: int):
    """(list, x) probe lanes of the Zipf boolean workload's conjunctions —
    the shortest term's documents probed into every other term, as an svs
    round does — plus edge lanes: the head, the last element, one past
    it, beyond the universe, and singleton lists."""
    import numpy as np
    from repro_torch.launch.serve import boolean_workload
    from repro_torch.query.ast import terms_of
    lids, xs = [], []
    for q in boolean_workload(len(lists), lengths, n_queries=2048,
                              seed=seed):
        ts = sorted(set(terms_of(q)), key=lambda t: lengths[t])
        if len(ts) < 2:
            continue
        short = np.asarray(lists[ts[0]][:256], np.int64)
        for t in ts[1:]:
            lids.append(np.full(short.size, t))
            xs.append(short)
        if sum(a.size for a in lids) >= K1_LANES:
            break
    edge_l, edge_x = [], []
    for t in [int(i) for i in np.argsort(lengths)[::-1][:16]] + [
            i for i in range(len(lists)) if lengths[i] == 1][:16]:
        arr = lists[t]
        for x in (0, arr[0], arr[len(arr) // 2], arr[-1], arr[-1] + 1,
                  universe + 5):
            edge_l.append(t)
            edge_x.append(int(x))
    lid = np.concatenate(lids)[:K1_LANES - len(edge_l)]
    x = np.concatenate(xs)[:K1_LANES - len(edge_l)]
    return (np.concatenate([lid, edge_l]).astype(np.int32),
            np.concatenate([x, edge_x]).astype(np.int32))


def _oracle_next_geq(lists, lids, xs):
    """numpy next_geq over the uncompressed lists, one searchsorted for
    all lanes: (list, doc) keys of every posting in one sorted array."""
    import numpy as np
    lens = np.fromiter((len(a) for a in lists), np.int64, len(lists))
    flat = np.concatenate(lists).astype(np.int64)
    ends = np.cumsum(lens)
    base = int(max(flat.max(), int(np.max(xs)))) + 2
    keys = np.repeat(np.arange(len(lists), dtype=np.int64), lens) * base \
        + flat
    lid = np.asarray(lids, np.int64)
    p = np.searchsorted(keys, lid * base + np.maximum(np.asarray(xs, np.int64),
                                                      0))
    return np.where(p < ends[lid], flat[np.minimum(p, flat.size - 1)],
                    2**31 - 1)


def _k3_lanes(lids, xs, lists, universe, lengths):
    """K3's batch over the ``ef`` tier, where every list is an EF list:
    K1's conjunction probes, with edge lanes for EF — on the longest lists
    (``l`` = 0 or 1) and on singletons (the widest ``l``): the head and one
    past it, the middle, the tail and one past it, the first and last value
    of the middle element's bucket, 0, -1, INT_MIN, beyond the universe and
    INT_MAX."""
    import numpy as np
    from repro_torch.core.ef import _list_lbits
    edge_l, edge_x = [], []
    for t in [int(i) for i in np.argsort(lengths)[::-1][:16]] + [
            i for i in range(len(lists)) if lengths[i] == 1][:16]:
        arr = np.asarray(lists[t], np.int64)
        l = _list_lbits(arr.size, int(arr[-1]))
        h = int(arr[arr.size // 2]) >> l
        for x in (arr[0], arr[0] + 1, arr[arr.size // 2], arr[-1],
                  arr[-1] + 1, h << l, ((h + 1) << l) - 1, 0, -1, -2**31,
                  universe + 5, 2**31 - 1):
            edge_l.append(t)
            edge_x.append(int(x))
    keep = K3_LANES - len(edge_l)
    return (np.concatenate([lids[:keep], edge_l]).astype(np.int32),
            np.concatenate([xs[:keep], edge_x]).astype(np.int32))


class _SortedPostings:
    """The library yardstick of K1 and K3: the uncompressed postings on the
    card as one sorted int64 key array ``list_id * base + doc``, so one
    ``torch.searchsorted`` (plus a gather and a select) answers ``next_geq``
    for any (list, x) lanes.  Timed beside the kernels, used nowhere in the
    port."""

    def __init__(self, lists, universe):
        import numpy as np
        import torch
        lens = np.fromiter((len(a) for a in lists), np.int64, len(lists))
        flat = np.concatenate(lists).astype(np.int64)
        self.base = int(universe) + 2
        keys = np.repeat(np.arange(len(lists), dtype=np.int64), lens) \
            * self.base + flat
        self.keys = torch.from_numpy(keys).cuda()
        self.vals = torch.from_numpy(flat.astype(np.int32)).cuda()
        self.ends = torch.from_numpy(np.cumsum(lens)).cuda()

    def query(self, lids, xs):
        """Search keys of the lanes: ``x`` clipped to ``[0, base - 1]``
        keeps every key inside its own list's range."""
        return lids.long() * self.base + xs.long().clamp(0, self.base - 1)

    def __call__(self, qkeys, lids):
        import torch
        p = torch.searchsorted(self.keys, qkeys)
        hit = p < self.ends[lids.long()]
        return torch.where(hit, self.vals[p.clamp(max=self.vals.numel() - 1)],
                           2**31 - 1)


def _library(lib, lids, xs, want) -> float:
    """Device ms of the library yardstick on these lanes (100 calls),
    after checking that it returns ``want``."""
    import torch
    qkeys = lib.query(lids, xs)
    if not torch.equal(lib(qkeys, lids), want):
        raise SystemExit("[kernels] the searchsorted yardstick disagrees "
                         "with the kernel")
    return _device_ms(lambda: lib(qkeys, lids), 100)[0]


def _serve(srv, queries, bags, lists, universe, wrappers):
    """Serve the boolean and then the ranked workload once through ``srv``
    with every launch count zeroed just before and read just after, and
    check every answer against ``naive_eval`` / ``rank_oracle``.  Records
    each kernel launch's batch size (lanes / entries) on the way in and
    keeps the inputs of each kernel's largest launch (overall and per
    workload), and of every K2 launch; a launch through a resident pool's
    slot table is counted and its pool and table are copied as they were.
    ``wrappers`` maps each (module, wrapper name) to the kernel it
    launches; the records are keyed by the kernel.  Returns the launches,
    shapes, those launches, times, latencies, stats and the answers."""
    import numpy as np
    import torch
    from repro_torch import kernels as KR
    from repro_torch.query import naive_eval, rank_oracle
    shapes = {name: [] for name in wrappers.values()}
    largest: dict[str, tuple] = {}
    by_phase: dict[tuple, tuple] = {}
    slot_calls = dict.fromkeys(shapes, 0)
    k2_calls = []
    phase = ["boolean"]

    def recording(name, fn):
        def call(*a, **kw):
            n = int(a[0].shape[0])
            shapes[name].append(n)
            rec = (n, phase[0], a, kw)
            if kw.get("slot_of_page") is not None:
                # the resident route: later fault batches rewrite the
                # pool in place, so keep this launch's pool and table
                slot_calls[name] += 1
                rec = (n, phase[0], (*a[:4], {k: v.clone() for k, v in
                                              a[4].items()}),
                       dict(kw, slot_of_page=kw["slot_of_page"].clone()))
            if n > largest.get(name, (0,))[0]:
                largest[name] = rec
            if n > by_phase.get((name, phase[0]), (0,))[0]:
                by_phase[(name, phase[0])] = rec
            if name == "page_score":
                k2_calls.append(rec)
            return fn(*a, **kw)
        return call

    saved = {key: getattr(*key) for key in wrappers}
    for (mod, attr), name in wrappers.items():
        setattr(mod, attr, recording(name, saved[(mod, attr)]))
    n0 = len(srv.scheduler.latencies)
    try:
        KR.reset_launches()
        t0 = time.perf_counter()
        outs = srv.search_many(queries)
        t_bool = time.perf_counter() - t0
        n_lat = len(srv.scheduler.latencies)
        phase[0] = "ranked"
        t0 = time.perf_counter()
        ranked = srv.search_topk_many(bags, TOPK)
        t_rank = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = dict(KR.LAUNCHES)
    finally:
        for (mod, attr), fn in saved.items():
            setattr(mod, attr, fn)
    lat = np.asarray(srv.scheduler.latencies, np.float64) * 1e3
    for q, got in zip(queries, outs):
        if not np.array_equal(got, naive_eval(q, lists, universe)):
            raise SystemExit(f"[serve] boolean answer differs: {q}")
    for bag, got in zip(bags, ranked):
        docs, scores = rank_oracle(lists, universe, bag, TOPK)
        if not (np.array_equal(got.docs, docs)
                and np.array_equal(got.scores, scores)):
            raise SystemExit(f"[serve] ranked answer differs: {bag}")
    return dict(launches=launches, shapes=shapes, largest=largest,
                by_phase=by_phase, slot_calls=slot_calls, k2_calls=k2_calls,
                t_bool=t_bool, t_rank=t_rank, lat_bool=lat[n0:n_lat],
                lat_rank=lat[n_lat:], stats=srv.serve_stats(), outs=outs,
                ranked=ranked)


def _hold(name, kernel, plain, args, kw, traffic, timing_args=None) -> tuple:
    """Run ``kernel`` and its plain version on the same card tensors; the
    outputs must be equal.  Returns the kernel's output and its numbers:
    device ms of both (kernel over 100 calls, plain over 3), per-call ms,
    and the bound from ``traffic()`` = (bytes, operations).  An iterator
    ``timing_args`` gives each timed call its own arguments (copies of
    ``args`` that keep the inputs out of L2)."""
    import torch
    out_k = kernel(*args, **kw)
    out_p = plain(*args, **kw)
    torch.cuda.synchronize()
    k, p = _as_int(out_k), _as_int(out_p)
    bad = int((k != p).sum())
    if bad:
        raise SystemExit(f"[kernels] {name} disagrees with its plain "
                         f"version in {bad} slots")
    err = int((k - p).abs().max()) if k.numel() else 0
    nxt = (lambda: args) if timing_args is None else \
        (lambda: next(timing_args))
    ms, wall = _device_ms(lambda: kernel(*nxt(), **kw), 100)
    plain_ms, plain_wall = _device_ms(lambda: plain(*nxt(), **kw), 3)
    nbytes, ops = traffic()
    bound, by = _bound(nbytes, ops)
    return out_k, dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=bound, bound_by=by, bound_bytes=nbytes,
                       bound_ops=ops, call_ms=wall, plain_call_ms=plain_wall)


def _print_hold(name: str, row: dict, unit: str, against: str) -> None:
    print(f"[kernels] {name}, {row['batch']}: {row['size']} {unit}, 0 "
          f"mismatches vs {against}; device {row['ms']:.5f} ms (plain "
          f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.6f} ms by "
          f"{row['bound_by']}: {row['bound_bytes']:.0f} B, "
          f"{row['bound_ops']:.0f} ops); per call {row['call_ms']:.4f} ms "
          f"(plain {row['plain_call_ms']:.3f} ms)")


def _kernel_row(name, source, replaces, launches, path, main,
                *others) -> dict:
    """One entry of the ``kernels`` line: the top-level numbers are those
    of the kernel's main launch (K1-K3: its largest serve launch; K4:
    round 1 of the cuda build; K5-K8: the full-size launch of phase 8),
    with its library yardstick's time there, if it has one; ``path_ms``
    is its device time summed over every launch on its path (K1, K2 in
    the ``repair`` serve pass, K3 in the ``ef`` pass, K4 over one cuda
    build, K5-K8 in phase 8), from ``torch.profiler``, with the launches
    the profile saw — or null (``path_from`` "not recorded") where no
    session recorded them all; every batch it was held on is under
    ``shapes``."""
    path_ms, path_n = path.get(name, (None, None))
    if name not in path:
        print(f"[timing] {name}: no profile session recorded every launch "
              f"of its path; path_ms not recorded")
    return dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=launches[name],
        max_abs_err=max(r["max_abs_err"] for r in (main, *others)),
        ms=main["ms"], plain_ms=main["plain_ms"],
        bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        library_ms=main.get("library_ms"), path_ms=path_ms,
        path_launches=path_n,
        path_from="profile" if name in path else "not recorded",
        shapes=[main, *others])


def _as_int(out):
    """A kernel's output as one int64 tensor, for comparison: a tuple is
    flattened, uint32 words are read as int32 (the same bits)."""
    import torch
    parts = out if isinstance(out, tuple) else (out,)
    return torch.cat([(p.view(torch.int32) if p.dtype == torch.uint32
                       else p).reshape(-1).long() for p in parts])


def k5_traffic(syms, tables, max_depth) -> tuple[float, float]:
    """Bytes and int32 operations the function of one K5 launch needs on
    these symbols, the same for any kernel: each symbol read once, its
    (32,) row written once, 16 bytes (four tables) for each distinct node
    of the expansions within the cut (an id outside the tables reads
    nothing); one operation per output slot and
    4 per node of each symbol's expansion tree within the cut and its 32
    slots (the split of a node's slots between its children).  The tree
    is walked by ranges of slots: the slots that reach a node split at
    ``lens[left]``; a terminal or a node at ``max_depth`` ends its range.
    Wants are counted in int64 (real grammars never wrap)."""
    import torch
    S = tables["sym_left"].numel()
    pad = lambda t, v: torch.cat([t.long(), t.new_full((1,), v).long()])
    left, right = pad(tables["sym_left"], -1), pad(tables["sym_right"], -1)
    lens = pad(tables["sym_len"], 1)
    at = lambda s: torch.where((s >= 0) & (s < S), s, S)
    sym = at(syms.long())
    lo = torch.ones_like(sym)
    n = lens[sym].clamp(0, 32)
    visited, nodes = [], 0
    for d in range(max_depth + 1):
        keep = n > 0
        sym, lo, n = sym[keep], lo[keep], n[keep]
        nodes += sym.numel()
        visited.append(torch.unique(sym))
        if d == max_depth:
            break
        l = left[sym]
        rule = l >= 0
        sym, lo, n, l = sym[rule], lo[rule], n[rule], at(l[rule])
        L = lens[l]
        nl = (L - lo + 1).clamp(min=0)
        nl = torch.minimum(nl, n)
        sym = torch.cat([l, at(right[sym])])
        lo = torch.cat([lo, lo + nl - L])
        n = torch.cat([nl, n - nl])
    distinct = int((torch.unique(torch.cat(visited)) < S).sum())
    w = syms.numel()
    return float(4 * w + 128 * w + 16 * distinct), float(32 * w + 4 * nodes)


def k5_layout(syms, tables) -> dict:
    """What a K5 launch's symbols ask of it: the share of the (W, 32)
    output slots that hold a gap, and the rule depth of the symbols
    (terminals 0), mean and max."""
    import torch
    left, right, lens = (tables[k].long() for k in ("sym_left",
                                                    "sym_right", "sym_len"))
    S = left.numel()
    rules = torch.nonzero(left >= 0).flatten()
    depth = torch.zeros(S, dtype=torch.long, device=left.device)
    while True:                  # children precede rules: settles in depth
        new = depth.clone()
        new[rules] = 1 + torch.maximum(depth[left[rules]],
                                       depth[right[rules]])
        if torch.equal(new, depth):
            break
        depth = new
    x = syms.long()
    d = depth[x].double()
    return dict(symbols=int(x.numel()),
                gap_slots=float(lens[x].clamp(0, 32).sum() / (32 * x.numel())),
                depth_mean=float(d.mean()), depth_max=int(d.max()))


def k7_traffic(a, b) -> tuple[float, float]:
    """Bytes and int32 operations the function of one K7 launch needs,
    the same for any kernel: a and b read and the output written once (12
    bytes a slot); 4 operations for each live (not INT_INF) slot of b to
    enter it in a set of the row, 4 for each live slot of a to look it
    up, and one select per slot."""
    inf = 2**31 - 1
    live = int((a != inf).sum()) + int((b != inf).sum())
    return float(12 * a.numel()), float(4 * live + a.numel())


def _k6_rows(lists, C: int):
    """Every posting list cut into rows of ``C`` d-gaps: row k of a list
    starts from the list's element k * C (the previous row's last decoded
    value) and decodes to the next ``C`` elements; a short row is padded
    with zero gaps.  Returns gaps, firsts, and per row its list and how
    many of its slots are real."""
    import numpy as np
    owner, take = [], []
    for i, l in enumerate(lists):
        n = len(l) - 1
        k = max(1, -(-n // C))
        owner += [i] * k
        take += [min(C, n - j * C) for j in range(k)]
    gaps = np.zeros((len(owner), C), np.int32)
    firsts = np.empty(len(owner), np.int32)
    r = 0
    for l in lists:
        d = np.diff(np.asarray(l, np.int64)).astype(np.int32)
        for j in range(max(1, -(-d.size // C))):
            seg = d[j * C:(j + 1) * C]
            gaps[r, :seg.size] = seg
            firsts[r] = l[j * C]
            r += 1
    return gaps, firsts, np.asarray(owner), np.asarray(take)


def _k7_pairs(queries, lists, universe):
    """The first two distinct terms (in AST order) of each boolean query
    with two or more, each list bucketized at ``AUX_KBITS`` over the
    index's universe; returns the pairs and the stacked (NB, 128) rows of
    their a and b sides."""
    import numpy as np
    from repro_torch.kernels.bucket_intersect import bucketize
    from repro_torch.query.ast import terms_of
    pairs = []
    for q in queries:
        ts = list(dict.fromkeys(terms_of(q)))
        if len(ts) >= 2:
            pairs.append((ts[0], ts[1]))
    a = np.concatenate([bucketize(lists[s], universe, AUX_KBITS, 128)
                        for s, _ in pairs])
    b = np.concatenate([bucketize(lists[t], universe, AUX_KBITS, 128)
                        for _, t in pairs])
    return pairs, a, b


def _searchsorted_intersect(a, b):
    """The library yardstick of K7 on bucketized (sorted) rows: one
    row-wise ``torch.searchsorted`` of a into b, a gather and a compare.
    Timed beside the kernel, used nowhere in the port."""
    import torch
    inf = 2**31 - 1
    pos = torch.searchsorted(b, a).clamp(max=b.shape[1] - 1)
    hit = (torch.gather(b, 1, pos) == a) & (a != inf)
    return torch.where(hit, a, inf)


def _isin_intersect(a, b):
    """The library yardstick of K7 on any rows, sorted or not: one
    ``torch.isin`` of int64 keys ``row << 32 | (a & 0xFFFFFFFF)`` against
    the same keys of b, then a select.  Timed beside the kernel, used
    nowhere in the port."""
    import torch
    inf = 2**31 - 1
    row = torch.arange(a.shape[0], device=a.device)[:, None] << 32
    hit = torch.isin(row | (a.long() & 0xFFFFFFFF),
                     row | (b.long() & 0xFFFFFFFF)) & (a != inf)
    return torch.where(hit, a, inf)


def _aux(lists, res, fi, queries, seed: int) -> dict:
    """Phase 8: the entry points of K5-K8 on the card, at full size and on
    the served index's own data.  Launch counts are zeroed just before
    the entry points run and read just after; then every output is checked
    against its numpy oracle, and each kernel is held against its plain
    version and timed.  Returns the launches and the rows of each kernel."""
    import itertools
    import numpy as np
    import torch
    from repro_torch import kernels as KR
    from repro_torch.core.bitmaps import build_bitmap
    from repro_torch.kernels.bitmap_and import ops as K8
    from repro_torch.kernels.bucket_intersect import ops as K7
    from repro_torch.kernels.gap_decode import ops as K6
    from repro_torch.kernels.grammar_expand import ops as K5
    rng = np.random.default_rng(seed)
    cuda = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
    inf = 2**31 - 1

    # inputs: K6 at decode_bulk resampled from the real d-gaps and heads,
    # and every list in rows of 4,096 plus a row that wraps
    R, C = DECODE_BULK
    real_gaps = np.concatenate([np.diff(np.asarray(l, np.int64))
                                for l in lists]).astype(np.int32)
    heads = np.asarray([l[0] for l in lists], np.int32)
    g6 = cuda(real_gaps[rng.integers(0, real_gaps.size, (R, C))])
    f6 = cuda(heads[rng.integers(0, heads.size, R)])
    rows_g, rows_f, owner, take = _k6_rows(lists, C)
    wrap_g = np.full((1, C), 7, np.int32)
    rows_g = np.concatenate([rows_g, wrap_g])
    rows_f = np.append(rows_f, np.int32(inf - 100))
    e6 = (cuda(rows_g), cuda(rows_f))
    # K5: every symbol of the served stream of at most PHRASE_CAP gaps;
    # terminals only (W = 1,037); the same symbols at half the depth
    tabs = [fi.sym_left, fi.sym_right, fi.sym_sum, fi.sym_len]
    syms5 = fi.c[fi.sym_len[fi.c.long()] <= K5.PHRASE_CAP].contiguous()
    terms5 = cuda(rng.integers(0, fi.num_terminals, 1037).astype(np.int32))
    cut5 = syms5[:100_003].contiguous()
    # K7: the boolean queries' first two terms, bucketized; random rows
    pairs, a7_np, b7_np = _k7_pairs(queries, lists, res.universe)
    a7, b7 = cuda(a7_np), cuda(b7_np)
    ea7_np = rng.integers(0, 500, (1037, 1500)).astype(np.int32)
    eb7_np = rng.integers(0, 500, (1037, 1500)).astype(np.int32)
    ea7_np[rng.random(ea7_np.shape) < 0.1] = inf
    eb7_np[rng.random(eb7_np.shape) < 0.1] = inf
    e7 = (cuda(ea7_np), cuda(eb7_np))
    # K8: one seeded pair at the repair-ir universe; the same pairs as K7
    # as bitmaps of the index's universe, stacked
    n8 = BITMAP_UNIVERSE // 32
    a8_np = rng.integers(0, 2**32, n8, dtype=np.uint32)
    b8_np = rng.integers(0, 2**32, n8, dtype=np.uint32)
    a8, b8 = cuda(a8_np), cuda(b8_np)
    bm = lambda t: build_bitmap(lists[t], res.universe).words.view(np.uint32)
    ea8_np = np.concatenate([bm(s) for s, _ in pairs])
    eb8_np = np.concatenate([bm(t) for _, t in pairs])
    e8 = (cuda(ea8_np), cuda(eb8_np))
    torch.cuda.synchronize()

    # the path: each entry point at full size and on its second batch
    def drive():
        outs = (K6.gap_decode(g6, f6), K6.gap_decode(*e6),
                K5.grammar_expand(syms5, *tabs, max_depth=fi.max_depth),
                K5.grammar_expand(terms5, *tabs, max_depth=fi.max_depth),
                K5.grammar_expand(cut5, *tabs,       # held below
                                  max_depth=fi.max_depth // 2),
                K7.bucket_intersect(a7, b7), K7.bucket_intersect(*e7),
                *K8.bitmap_and_count(a8, b8), *K8.bitmap_and_count(*e8))
        torch.cuda.synchronize()
        return outs

    KR.reset_launches()
    t0 = time.perf_counter()
    (out6, out6e, out5, out5t, _, out7, out7e, out8, cnt8, out8e,
     cnt8e) = drive()
    t_path = time.perf_counter() - t0
    launches = dict(KR.LAUNCHES)
    for name in AUX_KERNELS:
        if launches[name] == 0:
            raise SystemExit(f"[aux] {name} never launched: {launches}")

    # oracles
    dec = out6e.cpu().numpy()
    n_rows = owner.size
    body = dec[:n_rows][np.arange(C) < take[:, None]]
    cont = np.nonzero(owner[1:] == owner[:-1])[0] + 1
    if not (np.array_equal(body, np.concatenate(
            [np.asarray(l[1:], np.int64) for l in lists]))
            and np.array_equal(rows_f[cont], dec[cont - 1, C - 1])):
        raise SystemExit("[aux] gap_decode: the lists' rows do not decode "
                         "to their postings")
    want = (np.cumsum(wrap_g.astype(np.int64), 1) + (inf - 100)
            ).astype(np.uint32).view(np.int32)
    if not np.array_equal(dec[-1:], want):
        raise SystemExit("[aux] gap_decode: the wrapping row differs")
    left, right, sums = (t.cpu().numpy() for t in tabs[:3])
    rows5 = out5.cpu().numpy()
    syms_np = syms5.cpu().numpy()
    for w in rng.choice(syms_np.size, min(4096, syms_np.size),
                        replace=False):
        stack, want = [int(syms_np[w])], []
        while stack:
            t = stack.pop()
            if left[t] < 0:
                want.append(int(sums[t]))
            else:
                stack += [int(right[t]), int(left[t])]
        if rows5[w, :len(want)].tolist() != want \
                or rows5[w, len(want):].any():
            raise SystemExit(f"[aux] grammar_expand: symbol "
                             f"{syms_np[w]} differs from its expansion")
    t5 = out5t.cpu().numpy()
    if not (np.array_equal(t5[:, 0], sums[terms5.cpu().numpy()])
            and not t5[:, 1:].any()):
        raise SystemExit("[aux] grammar_expand: a terminal row differs")
    o7 = out7.cpu().numpy()
    nb = o7.shape[0] // len(pairs)
    for k, (s, t) in enumerate(pairs):
        if not np.array_equal(
                K7.unbucketize(o7[k * nb:(k + 1) * nb]),
                np.intersect1d(lists[s], lists[t])):
            raise SystemExit(f"[aux] bucket_intersect: pair {(s, t)} "
                             f"differs from np.intersect1d")
    o7e = out7e.cpu().numpy()
    for r in range(o7e.shape[0]):
        hit = (ea7_np[r] != inf) & np.isin(ea7_np[r], eb7_np[r])
        if not np.array_equal(o7e[r], np.where(hit, ea7_np[r], inf)):
            raise SystemExit(f"[aux] bucket_intersect: random row {r} "
                             f"differs from numpy")
    popc = lambda w: int(np.unpackbits(w.view(np.uint8)).sum())
    if not (np.array_equal(out8.cpu().numpy(), a8_np & b8_np)
            and int(cnt8) == popc(a8_np & b8_np)):
        raise SystemExit("[aux] bitmap_and_count differs from numpy at "
                         "2^25")
    o8e = out8e.cpu().numpy()
    nw = o8e.size // len(pairs)
    total = 0
    for k, (s, t) in enumerate(pairs):
        bits = np.unpackbits(o8e[k * nw:(k + 1) * nw].view(np.uint8),
                             bitorder="little")
        inter = np.intersect1d(lists[s], lists[t])
        total += inter.size
        if not np.array_equal(np.nonzero(bits)[0], inter):
            raise SystemExit(f"[aux] bitmap_and: pair {(s, t)} differs "
                             f"from np.intersect1d")
    if int(cnt8e) != total or total != popc(o8e):
        raise SystemExit("[aux] bitmap_and_count: the pairs' total differs")

    aux_launches = {k: launches[k] for k in AUX_KERNELS}
    _, path = _profile_path(drive, AUX_KERNELS)
    _print_path("aux", "the entry points run again under torch.profiler",
                path, AUX_KERNELS)
    print(f"[aux] entry points of K5-K8 on the card in {t_path:.3f} s "
          f"(inputs made before, checks and timing after), launches "
          f"{aux_launches}; every output equal its numpy oracle: "
          f"gap_decode's rows decode to the postings, "
          f"grammar_expand's sample equals the stack walk, "
          f"bucket_intersect and bitmap_and equal np.intersect1d on "
          f"{len(pairs)} query pairs, bitmap_and_count equals numpy's "
          f"popcount")

    # each kernel held against its plain version and timed
    def hold(name, kernel, plain, args, kw, traffic, batch, size, **extra):
        _, row = _hold(name, kernel, plain, args, kw, traffic, **extra)
        row = dict(batch=batch, size=size, **row)
        _print_hold(name, row, "elements", "plain")
        return row

    tables5 = dict(sym_left=fi.sym_left, sym_right=fi.sym_right,
                   sym_len=fi.sym_len)
    md = fi.max_depth
    k6 = [hold("gap_decode", K6.gap_decode, K6.gap_decode_plain, (g6, f6),
               {}, lambda: (8.0 * R * C + 4 * R, float(R * C)),
               f"decode_bulk {R} x {C}, gaps resampled from the index",
               R * C),
          hold("gap_decode", K6.gap_decode, K6.gap_decode_plain, e6, {},
               lambda: (8.0 * rows_g.size + 4 * rows_f.size,
                        float(rows_g.size)),
               f"every list in rows of {C} ({rows_f.size - 1} rows) plus a "
               f"wrapping row", int(rows_g.size))]
    lib6 = lambda: torch.cumsum(g6, 1, dtype=torch.int32) + f6[:, None]
    if not torch.equal(lib6(), out6):
        raise SystemExit("[aux] the cumsum yardstick disagrees with "
                         "gap_decode")
    k6[0]["library_ms"] = _device_ms(lib6, 20)[0]
    k5 = [hold("grammar_expand", K5.grammar_expand, K5.grammar_expand_plain,
               (syms5, *tabs), dict(max_depth=md),
               lambda: k5_traffic(syms5, tables5, md),
               f"served stream symbols of <= {K5.PHRASE_CAP} gaps, "
               f"max_depth {md}", int(syms5.numel())),
          hold("grammar_expand", K5.grammar_expand, K5.grammar_expand_plain,
               (terms5, *tabs), dict(max_depth=md),
               lambda: k5_traffic(terms5, tables5, md),
               "terminals only", int(terms5.numel())),
          hold("grammar_expand", K5.grammar_expand, K5.grammar_expand_plain,
               (cut5, *tabs), dict(max_depth=md // 2),
               lambda: k5_traffic(cut5, tables5, md // 2),
               f"max_depth cut to {md // 2}", int(cut5.numel()))]
    print(f"[kernels] grammar_expand's main launch, layout: "
          f"{json.dumps(k5_layout(syms5, tables5))}")
    k7 = [hold("bucket_intersect", K7.bucket_intersect,
               K7.bucket_intersect_plain, (a7, b7), {},
               lambda: k7_traffic(a7, b7),
               f"{len(pairs)} query pairs bucketized at kbits "
               f"{AUX_KBITS}, {a7.shape[0]} x {a7.shape[1]}",
               int(a7.numel())),
          hold("bucket_intersect", K7.bucket_intersect,
               K7.bucket_intersect_plain, e7, {},
               lambda: k7_traffic(*e7),
               "random unsorted rows with duplicates and INT_INF, "
               f"{e7[0].shape[0]} x {e7[0].shape[1]}", int(e7[0].numel()))]
    if not torch.equal(_searchsorted_intersect(a7, b7), out7):
        raise SystemExit("[aux] the searchsorted yardstick disagrees with "
                         "bucket_intersect")
    k7[0]["library_ms"] = _device_ms(
        lambda: _searchsorted_intersect(a7, b7), 100)[0]
    for row, args, out in ((k7[0], (a7, b7), out7), (k7[1], e7, out7e)):
        if not torch.equal(_isin_intersect(*args), out):
            raise SystemExit("[aux] the isin yardstick disagrees with "
                             "bucket_intersect")
        row["isin_ms"] = _device_ms(lambda: _isin_intersect(*args), 100)[0]
    k7[1]["library_ms"] = k7[1]["isin_ms"]
    print(f"[aux] bucket_intersect beside torch.isin on row-tagged int64 "
          f"keys: sorted rows {k7[0]['ms']:.5f} ms (isin "
          f"{k7[0]['isin_ms']:.5f}, searchsorted "
          f"{k7[0]['library_ms']:.5f}), random rows {k7[1]['ms']:.5f} ms "
          f"(isin {k7[1]['isin_ms']:.5f})")
    # K8 fits in L2: time it over eight copies of its operands in turn,
    # so that each launch finds its inputs cold, as a caller would
    cold = itertools.cycle([(a8.clone(), b8.clone()) for _ in range(8)])
    k8 = [hold("bitmap_and", K8.bitmap_and_count, K8.bitmap_and_count_plain,
               (a8, b8), {}, lambda: (12.0 * n8 + 4, 3.0 * n8),
               f"one seeded pair at universe {BITMAP_UNIVERSE} ({n8} words)",
               n8,
               timing_args=cold),
          hold("bitmap_and", K8.bitmap_and_count, K8.bitmap_and_count_plain,
               e8, {}, lambda: (12.0 * e8[0].numel() + 4,
                                3.0 * e8[0].numel()),
               f"{len(pairs)} query pairs as bitmaps of universe "
               f"{res.universe}, stacked", int(e8[0].numel()))]
    # the AND alone (PyTorch has no popcount), on int32 views of the same
    # cold copies
    k8[0]["library_ms"] = _device_ms(lambda: torch.bitwise_and(
        *(t.view(torch.int32) for t in next(cold))), 100)[0]
    return dict(launches=launches, path=path,
                rows=dict(grammar_expand=k5, gap_decode=k6,
                          bucket_intersect=k7, bitmap_and=k8))


def _outofcore(res, lists, queries, bags, run5, num_pages, tables1, host1,
               statics1, wrappers, lib) -> dict:
    """Phase 9: the phase-3 index served from an mmap page store through a
    bounded admission cache of ``num_pages // 10`` pages.  Launch counts
    are zeroed just before and read just after the serve pass; every K1
    launch must take the resident route (the pool's slot table); every
    answer must equal ``naive_eval`` / ``rank_oracle`` and phase 5's fully
    resident ``repair`` answers.  Then K1's largest resident launch of
    each workload is held against its plain version on the same pool and
    slot table, the pool's rows outside the launch's working set
    poisoned, and timed beside the fully resident route and the
    searchsorted yardstick ``lib`` on the same lanes.  Returns the run
    and the held rows."""
    import numpy as np
    import torch
    from repro_torch.kernels.list_intersect import ops as K1
    from repro_torch.serve import QueryServer
    budget = max(1, num_pages // 10)
    t0 = time.perf_counter()
    srv = QueryServer(res, engine="cuda", device="cuda",
                      batch_window=CONCURRENCY, codec="repair",
                      store="mmap", resident_pages=budget)
    t_up = time.perf_counter() - t0
    store = srv.engine.store
    print(f"[outofcore] QueryServer(engine='cuda', store='mmap', "
          f"resident_pages={budget}) up in {t_up:.2f} s: "
          f"{store.num_pages} pages x {store.page_size} symbols, "
          f"{store.disk_bytes / 2**20:.2f} MiB on disk; on the card "
          f"{srv.engine.pi.c_syms_pg.shape[0]}-row stream placeholders")
    run = _serve(srv, queries, bags, lists, res.universe, wrappers)
    k1 = run["launches"]["list_intersect"]
    if k1 == 0 or run["slot_calls"]["list_intersect"] \
            != len(run["shapes"]["list_intersect"]):
        raise SystemExit(f"[outofcore] K1's resident route: {k1} launches, "
                         f"{run['slot_calls']['list_intersect']} of "
                         f"{len(run['shapes']['list_intersect'])} calls "
                         f"through the slot table")
    for got, want in zip(run["outs"], run5["outs"]):
        if not np.array_equal(got, want):
            raise SystemExit("[outofcore] a boolean answer differs from "
                             "phase 5's fully resident one")
    for got, want in zip(run["ranked"], run5["ranked"]):
        if not (np.array_equal(got.docs, want.docs)
                and np.array_equal(got.scores, want.scores)):
            raise SystemExit("[outofcore] a ranked answer differs from "
                             "phase 5's fully resident one")
    st, rs = run["stats"], srv.engine.resident.stats()
    lat_b, lat_r = run["lat_bool"], run["lat_rank"]
    print(f"[outofcore] boolean: {len(queries)} queries at concurrency "
          f"{CONCURRENCY} in {run['t_bool']:.3f} s "
          f"({len(queries) / run['t_bool']:.1f} q/s), p50 "
          f"{np.percentile(lat_b, 50):.2f} ms, p95 "
          f"{np.percentile(lat_b, 95):.2f} ms; ranked top-{TOPK}: "
          f"{len(bags)} queries in {run['t_rank']:.3f} s "
          f"({len(bags) / run['t_rank']:.1f} q/s), p50 "
          f"{np.percentile(lat_r, 50):.2f} ms, p95 "
          f"{np.percentile(lat_r, 95):.2f} ms; every answer equal "
          f"naive_eval / rank_oracle and phase 5's fully resident answers")
    print(f"[outofcore] launches {run['launches']} (every K1 call through "
          f"the slot table); K1 launch shapes (lanes) "
          f"{run['shapes']['list_intersect']}")
    print(f"[outofcore] ResidentSet.stats(): {json.dumps(rs)}")
    print(f"[outofcore] scheduler: prefetched {st['prefetched_pages']} "
          f"pages, {st['prefetch_useful']} useful (accuracy "
          f"{st['prefetch_accuracy']:.3f}), gather "
          f"{st['prefetch_gather_ms']:.1f} ms, join wait "
          f"{st['prefetch_join_wait_ms']:.1f} ms, overlap "
          f"{st['overlap_ms']:.1f} ms; pool_grows {rs['pool_grows']} (a "
          f"tick whose working set exceeds the budget grows the pool)")

    def fresh_pass():
        fresh = QueryServer(res, engine="cuda", device="cuda",
                            batch_window=CONCURRENCY, codec="repair",
                            store="mmap", resident_pages=budget)
        fresh.search_many(queries)
        fresh.search_topk_many(bags, TOPK)

    _, path = _profile_path(fresh_pass, ["list_intersect"])
    _print_path("outofcore", f"a fresh out-of-core serve pass (the pass "
                f"above launched {k1})", path, ["list_intersect"])

    rows = []
    for ph in ("ranked", "boolean"):
        rec = run["by_phase"].get(("list_intersect", ph))
        if rec is None:
            continue
        n, _, a, kw = rec
        lanes, pool = a[:4], a[4]
        ws = K1.probe_working_set(host1, a[0].cpu().numpy(),
                                  a[1].cpu().numpy())
        poisoned = K1.poison_outside(pool["c_syms_pg"], pool["c_sums_pg"],
                                     kw["slot_of_page"], ws, seed=n)
        out, row = _hold("list_intersect", K1.paged_intersect,
                         K1.paged_intersect_plain, a, kw,
                         lambda: k1_traffic(lanes, tables1, statics1,
                                            page=store.page_size))
        oracle = _oracle_next_geq(lists, a[0].cpu().numpy(),
                                  a[1].cpu().numpy())
        full = K1.paged_intersect(*lanes, tables1, **statics1)
        if not (np.array_equal(out.cpu().numpy(), oracle)
                and torch.equal(out, full)):
            raise SystemExit(f"[outofcore] K1's resident route disagrees "
                             f"with the oracle or the fully resident route "
                             f"on the largest {ph} launch")
        full_ms = _device_ms(
            lambda: K1.paged_intersect(*lanes, tables1, **statics1), 100)[0]
        full_bound = _bound(*k1_traffic(lanes, tables1, statics1))[0]
        row = dict(batch=f"resident route: largest out-of-core serve launch "
                   f"({ph} queries), pool of {pool['c_syms_pg'].shape[0]} "
                   f"rows for {store.num_pages} pages, working set "
                   f"{ws.size} pages, {poisoned} rows outside it poisoned",
                   size=n, route="resident", launches=k1,
                   path_ms=path.get("list_intersect", (None,))[0],
                   fully_resident_ms=full_ms,
                   fully_resident_bound_ms=full_bound,
                   library_ms=_library(lib, a[0], a[1], out), **row)
        _print_hold("list_intersect", row, "lanes",
                    "plain (poisoned pool), oracle and the fully resident "
                    "route")
        print(f"[outofcore] the same lanes through the fully resident "
              f"route: {full_ms:.5f} ms (bound {full_bound:.6f} ms)")
        rows.append(row)
    return dict(run=run, rows=rows, stats=rs)


def _ingest(res, lists, term_ids, vocab: int, seed: int,
            n_rounds: int = INGEST_ROUNDS, mesh=None) -> dict:
    """Phase 10: streaming ingestion over the phase-3 index on the card.
    A ``QueryServer(engine="cuda")`` over the served index takes
    ``INGEST_DOCS`` new documents of the same law (``zipf_corpus`` at mean
    length 120, its words mapped onto the index's list ids) in
    ``INGEST_ROUNDS`` rounds, through ``enable_ingest`` at the defaults
    users run (``INGEST_BUDGET`` 256, ``INGEST_FANOUT`` 4) with the cuda
    builder at
    ``table_cap=4096`` (K4 on every flush and compaction); the stream ends
    with an explicit ``flush``.  After each round, ``INGEST_BOOLEAN``
    boolean and ``INGEST_RANKED`` top-10 queries over the current corpus,
    every answer checked against ``naive_eval`` / ``rank_oracle`` over
    the base plus the inserted documents.  Counts are zeroed just before
    the phase and read just after: K1, K2 and K4 must launch.  Returns
    the phase's numbers.

    Phase 11c runs the first ``n_rounds`` rounds under ``mesh``: every
    segment engine is then list-sharded, the merged rounds take the
    sharded dispatch (K1 on each shard), and at least one sharded
    dispatch must be counted."""
    import numpy as np
    import torch
    from repro_torch import kernels as KR
    from repro_torch.build import make_builder
    from repro_torch.engine import device as D
    from repro_torch.index.corpus import zipf_corpus
    from repro_torch.launch.serve import boolean_workload, ranked_workload
    from repro_torch.query import naive_eval, rank_oracle
    from repro_torch.serve import QueryServer

    word_to_list = np.full(vocab, -1, np.int64)
    word_to_list[np.asarray(term_ids, np.int64)] = np.arange(len(lists))
    new_docs = []
    for words in zipf_corpus(num_docs=INGEST_DOCS, vocab_size=vocab,
                             mean_doc_len=120, seed=seed + 1).doc_terms:
        ids = word_to_list[words]
        new_docs.append(np.sort(ids[ids >= 0]))
    srv = QueryServer(res, engine="cuda", device="cuda",
                      batch_window=CONCURRENCY, codec="repair", mesh=mesh)
    seg = srv.enable_ingest(
        delta_budget=INGEST_BUDGET, compact_fanout=INGEST_FANOUT,
        builder=make_builder("cuda", device="cuda",
                             table_cap=BUILD_TABLE_CAP))
    compact_ms = [0.0]
    step = seg.compact_step

    def timed_step():
        t0 = time.perf_counter()
        merged = step()
        if merged:
            torch.cuda.synchronize()
            compact_ms[0] += (time.perf_counter() - t0) * 1e3
        return merged
    seg.compact_step = timed_step
    extra: dict[int, list[int]] = {}
    per_round = INGEST_DOCS // INGEST_ROUNDS
    rounds, t_insert = [], 0.0
    KR.reset_launches()
    D.reset_dispatches()
    for r in range(n_rounds):
        t0 = time.perf_counter()
        for d in new_docs[r * per_round:(r + 1) * per_round]:
            gid = srv.insert(d)
            for t in d.tolist():
                extra.setdefault(t, []).append(gid)
        if r == n_rounds - 1:
            srv.flush()                   # the stream's end: freeze the tail
        torch.cuda.synchronize()
        t_insert += time.perf_counter() - t0
        n = seg.total_docs
        cur = [np.concatenate([l, np.asarray(extra.get(t, ()), np.int64)])
               for t, l in enumerate(lists)]
        lengths = [len(l) for l in cur]
        queries = boolean_workload(len(cur), lengths,
                                   n_queries=INGEST_BOOLEAN,
                                   seed=seed + 100 + r)
        bags = ranked_workload(len(cur), lengths, n_queries=INGEST_RANKED,
                               seed=seed + 100 + r)
        t0 = time.perf_counter()
        outs = srv.search_many(queries)
        t_b = time.perf_counter() - t0
        lat_b = list(srv.scheduler.latencies)[-len(queries):]
        t0 = time.perf_counter()
        ranked = srv.search_topk_many(bags, TOPK)
        t_r = time.perf_counter() - t0
        lat_r = list(srv.scheduler.latencies)[-len(bags):]
        for q, got in zip(queries, outs):
            if not np.array_equal(got, naive_eval(q, cur, n)):
                raise SystemExit(f"[ingest] round {r}: boolean answer "
                                 f"differs: {q}")
        for bag, got in zip(bags, ranked):
            docs, scores = rank_oracle(cur, n, bag, TOPK)
            if not (np.array_equal(got.docs, docs)
                    and np.array_equal(got.scores, scores)):
                raise SystemExit(f"[ingest] round {r}: ranked answer "
                                 f"differs: {bag}")
        tel = seg.telemetry()
        rounds.append(dict(
            docs=n, segments=tel["segments"], flushes=tel["flushes"],
            compactions=tel["compactions"], bool_qps=len(queries) / t_b,
            bool_p50=float(np.percentile(lat_b, 50)) * 1e3,
            bool_p95=float(np.percentile(lat_b, 95)) * 1e3,
            rank_qps=len(bags) / t_r,
            rank_p50=float(np.percentile(lat_r, 50)) * 1e3,
            rank_p95=float(np.percentile(lat_r, 95)) * 1e3))
    torch.cuda.synchronize()
    launches = dict(KR.LAUNCHES)
    dispatches = D.DISPATCHES["sharded_next_geq"]
    tel = seg.telemetry()
    new_docs = new_docs[:n_rounds * per_round]
    postings = sum(d.size for d in new_docs)
    for name in ("list_intersect", "page_score", "pair_count"):
        if launches[name] == 0:
            raise SystemExit(f"[ingest] {name} never launched in the "
                             f"phase: {launches}")
    if mesh is not None and dispatches == 0:
        raise SystemExit("[ingest] no sharded dispatch under the mesh")
    if tel["flushes"] < n_rounds or (n_rounds == INGEST_ROUNDS
                                     and tel["compactions"] < 2):
        raise SystemExit(f"[ingest] {tel['flushes']} flushes and "
                         f"{tel['compactions']} compactions: the stream did "
                         f"not flush and compact as expected")
    for s in seg.segments:
        if s.engine is not None and s.engine.device != srv.engine.device:
            raise SystemExit("[ingest] a segment engine is off the card")
        if s.engine is not None and mesh is not None \
                and s.engine._sharded_next_geq is None:
            raise SystemExit("[ingest] a segment engine is not sharded")
    return dict(docs=len(new_docs), postings=postings, t_insert=t_insert,
                dispatches=dispatches,
                compact_ms=compact_ms[0], telemetry=tel, rounds=rounds,
                launches=launches,
                layout=[(s.base, s.num_docs, s.gen) for s in seg.segments])


def _mesh_serve(srv, queries, bags, lists, universe, wrappers, pairs,
                run5) -> dict:
    """One list-sharded server's pass: the boolean and ranked workloads
    through ``_serve`` (given no ``bags``, the boolean workload as the
    planner runs it and again with svs forced), then ``pairs`` through
    ``and_batch`` (the engine API whose ``_probe_dev`` keeps K1), each
    with the launch and dispatch counts zeroed just before and read just
    after.  Every answer must equal the oracles and ``run5``'s unsharded
    answers."""
    import numpy as np
    import torch
    from repro_torch import kernels as KR
    from repro_torch.engine import device as D
    from repro_torch.query import naive_eval
    call, seen = srv.engine._sharded_next_geq, {}

    def recording(g, x):
        if np.size(g) > np.size(seen.get("g", ())):
            seen.update(g=np.array(g), x=np.array(x))
        return call(g, x)
    srv.engine._sharded_next_geq = recording
    D.reset_dispatches()
    if bags:
        run = _serve(srv, queries, bags, lists, universe, wrappers)
        ranked = run["ranked"]
    else:
        # the planner's choice, then every conjunction forced to svs (at
        # this scale the planner may pick merge and bys, which are not
        # sharded, for every step)
        KR.reset_launches()
        t0 = time.perf_counter()
        outs = srv.search_many(queries)
        torch.cuda.synchronize()
        t_bool = time.perf_counter() - t0
        svs = srv.search_many(queries, "svs")
        torch.cuda.synchronize()
        run = dict(t_bool=t_bool, outs=outs, launches=dict(KR.LAUNCHES),
                   t_rank=None, stats=srv.serve_stats())
        ranked = []
        for q, got, forced in zip(queries, outs, svs):
            want = naive_eval(q, lists, universe)
            if not (np.array_equal(got, want)
                    and np.array_equal(forced, want)):
                raise SystemExit(f"[mesh] boolean answer differs: {q}")
    run["dispatches"] = D.DISPATCHES["sharded_next_geq"]
    for got, want in zip(run["outs"], run5["outs"]):
        if not np.array_equal(got, want):
            raise SystemExit("[mesh] a boolean answer differs from phase "
                             "5's unsharded one")
    for got, want in zip(ranked, run5["ranked"]):
        if not (np.array_equal(got.docs, want.docs)
                and np.array_equal(got.scores, want.scores)):
            raise SystemExit("[mesh] a ranked answer differs from phase "
                             "5's unsharded one")
    KR.reset_launches()
    D.reset_dispatches()
    t0 = time.perf_counter()
    outs = srv.and_batch(pairs)
    torch.cuda.synchronize()
    run["t_pairs"] = time.perf_counter() - t0
    run["pair_launches"] = dict(KR.LAUNCHES)
    run["pair_dispatches"] = D.DISPATCHES["sharded_next_geq"]
    for (a, b), got in zip(pairs, outs):
        if not np.array_equal(got, np.intersect1d(lists[a], lists[b])):
            raise SystemExit(f"[mesh] and_batch answer differs: {(a, b)}")
    srv.engine._sharded_next_geq = call
    if "g" not in seen:
        raise SystemExit("[mesh] no sharded round in the pass")
    run["hold"] = _hold_sharded(srv.engine, call, seen["g"], seen["x"])
    return run


def _hold_sharded(eng, call, g, x) -> dict:
    """The largest sharded round's lanes through the sharded route again
    and through the plain flat program over the whole index on the card
    (``torch_backend.next_geq_batch``): the answers must be equal.  Wall
    ms per call of each (host routing included), median of 5 after a
    warm-up; these launches come after the counts were read."""
    import numpy as np
    import torch
    from repro_torch.engine import torch_backend as J
    lt = torch.from_numpy(np.ascontiguousarray(g, np.int32)).to(eng.device)
    xt = torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(eng.device)

    def flat():
        return J.next_geq_batch(eng.fi, lt, xt).cpu().numpy()

    def wall(fn):
        fn()
        ts = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ts))
    got, want = call(g, x), flat()
    err = int(np.abs(got.astype(np.int64) - want.astype(np.int64)).max())
    if err:
        raise SystemExit(f"[mesh] the sharded route differs from the flat "
                         f"program on the largest round: {err}")
    return dict(lanes=int(np.size(g)), err=err, ms=wall(lambda: call(g, x)),
                plain_ms=wall(flat))


def _print_sharded_hold(what: str, hold: dict) -> None:
    print(f"[mesh] {what}: the largest sharded round ({hold['lanes']} "
          f"lanes) through the sharded route {hold['ms']:.3f} ms, through "
          f"the plain flat program over the whole index "
          f"{hold['plain_ms']:.3f} ms (wall, host routing included); "
          f"max_abs_err {hold['err']}")


def _mesh(res, lists, queries, bags, runs, tiers, wrappers, seed) -> dict:
    """Phase 11: list-sharded serving, ``QueryServer(engine="cuda",
    mesh=...)``.  11a: a ``Mesh([cuda:0])`` server per codec (``repair``,
    ``adaptive``) over phase 5's 256 boolean and 64 top-10 queries, plus
    ``MESH_PAIRS`` conjunctions through ``and_batch``; the merged rounds
    must take the sharded dispatch, K2 serve the ranked decodes, K1 the
    pairs' ``_probe_dev`` (``repair``) and K3 the EF lanes
    (``adaptive``); K1 launches at least once per sharded dispatch.  11b: the boolean queries and the pairs again on
    ``Mesh([cuda:0, cuda:0])``, each shard's lists, stream length and the
    bytes of its tables on the card printed.  Every answer equals phase
    5's and the oracles.  Between them, a fresh ``repair`` pass over a
    quarter of the workloads runs unsharded and on ``Mesh([cuda:0])``
    under ``torch.profiler``: the device's busy time and its largest
    entries, side by side."""
    import numpy as np
    import torch
    from repro_torch.distributed import Mesh
    from repro_torch.engine import device as D
    from repro_torch.serve import QueryServer
    card = torch.device("cuda", 0)
    rng = np.random.default_rng(seed + 11)
    pairs = [tuple(map(int, rng.choice(len(lists), 2, replace=False)))
             for _ in range(MESH_PAIRS)]
    out = {}
    for codec in ("repair", "adaptive"):
        srv = QueryServer(res, engine="cuda", device="cuda",
                          batch_window=CONCURRENCY,
                          codec=tiers.get(codec, codec),
                          mesh=Mesh([card]))
        run = _mesh_serve(srv, queries, bags, lists, res.universe,
                          wrappers, pairs, runs[codec][1])
        la, lp = run["launches"], run["pair_launches"]
        need = {"repair": ("page_score",), "adaptive": ("ef_next_geq",)}
        if run["dispatches"] == 0 or any(la[k] == 0 for k in need[codec]) \
                or la["list_intersect"] < run["dispatches"] \
                or (codec == "repair" and lp["list_intersect"] == 0):
            raise SystemExit(f"[mesh] {codec}: {run['dispatches']} sharded "
                             f"dispatches, launches {la}, pairs' launches "
                             f"{lp}")
        print(f"[mesh] 11a Mesh([cuda:0]) codec {codec}: boolean "
              f"{len(queries) / run['t_bool']:.1f} q/s, ranked "
              f"{len(bags) / run['t_rank']:.1f} q/s (phase 5 unsharded: "
              f"{len(queries) / runs[codec][1]['t_bool']:.1f} / "
              f"{len(bags) / runs[codec][1]['t_rank']:.1f}); sharded "
              f"dispatches {run['dispatches']}; launches K1 "
              f"{la['list_intersect']}, K2 {la['page_score']}, K3 "
              f"{la['ef_next_geq']}; {len(pairs)} pairs through and_batch "
              f"in {run['t_pairs']:.3f} s: launches K1 "
              f"{lp['list_intersect']}, K3 {lp['ef_next_geq']}, sharded "
              f"dispatches {run['pair_dispatches']}; every answer equal "
              f"phase 5's and naive_eval / rank_oracle / np.intersect1d")
        _print_sharded_hold(f"11a {codec}", run["hold"])
        out[codec] = run

    # where the sharded route's device time goes: fresh 'repair' servers
    # (no memo, no result cache), unsharded and on Mesh([cuda:0]), built
    # before the profiler starts, over the same quarter of the workloads
    # under torch.profiler
    def serving(mesh):
        s = QueryServer(res, engine="cuda", device="cuda",
                        batch_window=CONCURRENCY, codec="repair", mesh=mesh)

        def run():
            s.search_many(queries[:len(queries) // 4])
            s.search_topk_many(bags[:len(bags) // 4], TOPK)
        return run

    for what, mesh in (("unsharded", None),
                       ("Mesh([cuda:0])", Mesh([card]))):
        fn = serving(mesh)
        D.reset_dispatches()
        prof = _profile(fn)
        _print_profile("mesh", f"a fresh {what} 'repair' pass "
                       f"({len(queries) // 4} boolean + {len(bags) // 4} "
                       f"ranked queries, "
                       f"{D.DISPATCHES['sharded_next_geq']} sharded "
                       f"dispatches)", prof)
    srv = QueryServer(res, engine="cuda", device="cuda",
                      batch_window=CONCURRENCY, codec="repair",
                      mesh=Mesh([card, card]))
    call = srv.engine._sharded_next_geq
    sof = [sh["lists"] for sh in call.shards]
    nbytes = sum(t.numel() * t.element_size()
                 for sh in call.shards for t in sh["tables"].values())
    stream = [sh["stream"] for sh in call.shards]
    run = _mesh_serve(srv, queries, [], lists, res.universe, wrappers,
                      pairs, runs["repair"][1])
    if run["dispatches"] == 0 or run["pair_launches"]["list_intersect"] == 0 \
            or run["launches"]["list_intersect"] < 2 * run["dispatches"]:
        raise SystemExit(f"[mesh] 11b: {run['dispatches']} sharded "
                         f"dispatches, pairs' launches "
                         f"{run['pair_launches']}")
    print(f"[mesh] 11b Mesh([cuda:0, cuda:0]): shards own {sof} "
          f"lists, streams of {stream} symbols; the shards' tables hold "
          f"{nbytes / 2**20:.2f} MiB on the card (their paged stream "
          f"packs) beside the engine's own index (the second copy of the "
          f"stream); boolean "
          f"{len(queries) / run['t_bool']:.1f} q/s, sharded dispatches "
          f"{run['dispatches']}, launches K1 "
          f"{run['launches']['list_intersect']} (svs forced in a second "
          f"pass); pairs: K1 "
          f"{run['pair_launches']['list_intersect']} launches; every "
          f"answer equal phase 5's and naive_eval / np.intersect1d")
    _print_sharded_hold("11b", run["hold"])
    out["two"] = dict(run, lists=sof, stream=stream, bytes=nbytes)
    return out


def lm_recorded(model, scfg, prompts, device, forced=None):
    """``DecodeEngine`` over ``prompts`` with every prefill's and decode
    step's inputs and logits recorded; with ``forced`` (another run's
    records) the model's logits are replaced by that run's, so the engine
    follows its tokens (teacher forcing).  Returns (finished, events)."""
    import torch
    from repro_torch.serve import DecodeEngine
    eng = DecodeEngine(model, scfg, device=device)
    events = []
    prefill, step = model.prefill, model.decode_step

    def record(inputs, logits):
        events.append((inputs, eng.live.copy(), logits.float().cpu()))
        if forced is None:
            return logits
        return forced[len(events) - 1][2].to(logits.device)

    def rec_prefill(tokens):
        logits, cache = prefill(tokens)
        return record((tokens.clone(),), logits), cache

    def rec_step(token, cache, position):
        logits, cache = step(token, cache, position)
        return record((token.clone(), position.clone()), logits), cache

    model.prefill, model.decode_step = rec_prefill, rec_step
    try:
        for pr in prompts:
            eng.submit(pr)
        with torch.inference_mode():
            return eng.run_until_drained(), events
    finally:
        del model.prefill, model.decode_step


def _lm_forced(cpu, card, scfg, prompts, tol=None) -> dict:
    """The engine on the CPU, then on the card teacher-forced on the CPU's
    tokens: every prefill and step must see the same inputs and finish the
    same requests; the logits must agree within ``tol`` (by default
    ``LM_TOL`` × the CPU run's max|logit|), and the argmax must agree
    wherever the CPU's top-2 margin exceeds it."""
    import numpy as np
    import torch
    done_c, ev_c = lm_recorded(cpu, scfg, prompts, "cpu")
    done_g, ev_g = lm_recorded(card, scfg, prompts, card.device,
                                forced=ev_c)
    peak = max(float(e[2].abs().max()) for e in ev_c)
    tol = LM_TOL * peak if tol is None else tol
    if done_g != done_c or len(done_c) != len(prompts) \
            or len(ev_g) != len(ev_c):
        raise SystemExit("[lm] the card's engine finished other requests "
                         "than the CPU's")
    err, margins, rows = 0.0, 0, 0
    for (ig, lg, xg), (ic, lc, xc) in zip(ev_g, ev_c):
        if not all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(ig, ic)) \
                or not np.array_equal(lg, lc):
            raise SystemExit("[lm] the card's engine saw other inputs than "
                             "the CPU's")
        if not torch.isfinite(xg).all():
            raise SystemExit("[lm] NaN or inf in the card's logits")
        err = max(err, float((xg - xc).abs().max()))
        lanes = [0] if len(ig) == 1 else np.nonzero(lc)[0]
        for lane in lanes:
            top2 = torch.topk(xc[lane], 2).values
            rows += 1
            if float(top2[0] - top2[1]) > tol:
                margins += 1
                if int(xg[lane].argmax()) != int(xc[lane].argmax()):
                    raise SystemExit("[lm] argmax differs where the CPU's "
                                     "top-2 margin exceeds the tolerance")
    if err > tol:
        raise SystemExit(f"[lm] card logits differ from the CPU's by {err} "
                         f"> {tol}")
    return dict(requests=len(done_c), tokens=sum(map(len, done_c)),
                events=len(ev_c), max_abs_err=err, tol=tol,
                max_abs_logit=peak, argmax_rows=rows,
                argmax_checked=margins)


def _lm_step_bytes(model, positions, batch: int) -> tuple[float, float]:
    """The bytes one decode step must move: every parameter but the
    embedding read once (the embedding's ``batch`` rows gathered), each
    lane's valid cache slots read (k and v, every layer) and its new entry
    written, and the float32 logits written; and the bf16 operations of
    its products (2 per multiply-add)."""
    cfg = model.cfg
    per = 2                                            # bytes per bf16
    w = sum(p.numel() * p.element_size() for n, p in
            model.named_parameters() if n != "embed")
    gather = batch * cfg.d_model * per
    slots = sum(min(int(p), LM_SERVE["s_cache"] - 1) + 1 for p in positions)
    kv_row = cfg.n_kv * cfg.head_dim * per * 2 * cfg.n_layers
    kv = slots * kv_row + batch * kv_row
    logits = batch * cfg.padded_vocab * 4
    macs = batch * (cfg.active_param_count()
                    - cfg.padded_vocab * cfg.d_model) \
        + slots * cfg.n_heads * cfg.head_dim * 2 * cfg.n_layers
    return float(w + gather + kv + logits), float(2 * macs)


def _lm_busy(fn) -> dict:
    """``fn`` once under ``torch.profiler`` (device activity only, after a
    warm-up session, so that neither the profiler's start nor a host
    profiler inflates the wall): its wall ms, the device-busy ms (every
    kernel and copy, summed), the number of device activities and the
    five largest entries."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = [(e.key, getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0.0)) / 1e3,
            e.count) for e in prof.key_averages()]
    dev = sorted((d for d in dev if d[1] > 0), key=lambda d: -d[1])
    return dict(wall=wall, busy=sum(ms for _, ms, _ in dev),
                events=sum(n for _, _, n in dev),
                device=[(k[:80], ms) for k, ms, _ in dev[:5]])


def _lm_serve(model, rng, card, tag: str, sub: str,
              requests: int = LM_REQUESTS, **serve) -> dict:
    """``requests`` requests with prompts of ``LM_PROMPTS`` tokens through
    ``DecodeEngine(**LM_SERVE)`` (``serve`` overrides it) over ``model`` on
    ``card``, every prefill and decode tick timed (the device synchronised
    around each), decode step ``LM_PROFILE_STEP`` under the profiler;
    printed under ``[tag] sub``.  Returns the numbers."""
    import numpy as np
    import torch
    from repro_torch.serve import DecodeEngine, ServeConfig
    scfg = ServeConfig(**dict(LM_SERVE, **serve))
    eng = DecodeEngine(model, scfg, device=card)
    lens = [int(n) for n in rng.integers(LM_PROMPTS[0], LM_PROMPTS[1] + 1,
                                         requests)]
    for n in lens:
        eng.submit(rng.integers(1, model.cfg.vocab, n))
    prefill, step = model.prefill, model.decode_step
    pre_ms, tick_ms, prof = [], [], {}

    def timed_prefill(tokens):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = prefill(tokens)
        torch.cuda.synchronize()
        pre_ms.append((int(tokens.shape[1]), (time.perf_counter() - t) * 1e3))
        return r

    def timed_step(token, cache, position):
        if len(tick_ms) == LM_PROFILE_STEP:
            res = []
            prof.update(_lm_busy(lambda: res.append(step(token, cache,
                                                         position))))
            prof["positions"] = position.tolist()
            tick_ms.append(None)
            return res[0]
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = step(token, cache, position)
        torch.cuda.synchronize()
        tick_ms.append((time.perf_counter() - t) * 1e3)
        return r

    model.prefill, model.decode_step = timed_prefill, timed_step
    try:
        t0 = time.perf_counter()
        with torch.inference_mode():
            done = eng.run_until_drained()
        wall = time.perf_counter() - t0
    finally:
        del model.prefill, model.decode_step
    if len(done) != requests:
        raise SystemExit(f"[{tag}] {sub} {len(done)} of {requests} requests "
                         f"finished")
    toks_out = sum(map(len, done))
    ticks = [t for t in tick_ms if t is not None]
    nbytes, ops = _lm_step_bytes(model, prof["positions"],
                                 scfg.max_batch)
    bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / 989e12) * 1e3
    busy = 100 * prof["busy"] / prof["wall"]
    c = dict(requests=len(done), tokens=toks_out, wall_s=wall,
             tokens_per_s=toks_out / wall,
             prefill_ms=sorted(pre_ms), decode_ticks=len(tick_ms),
             decode_ms_median=float(np.median(ticks)),
             decode_ms_min=min(ticks), decode_ms_max=max(ticks),
             max_memory_allocated=torch.cuda.max_memory_allocated(),
             profiled_step=dict(wall_ms=prof["wall"], busy_ms=prof["busy"],
                                busy_pct=busy, device_activities=prof[
                                    "events"], top=prof["device"],
                                positions=prof["positions"]),
             step_bytes=nbytes, step_ops=ops, step_bound_ms=bound_ms,
             step_bound_by="bytes" if nbytes / HBM_BYTES_PER_S >=
             ops / 989e12 else "operations")
    print(f"[{tag}] {sub} served {len(done)} requests (prompts "
          f"{min(lens)}-{max(lens)} tokens) / {toks_out} tokens in "
          f"{wall:.2f} s: {toks_out / wall:.1f} tok/s; {len(tick_ms)} "
          f"decode ticks, median {np.median(ticks):.2f} ms (min "
          f"{min(ticks):.2f}, max {max(ticks):.2f}); max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    print(f"[{tag}] {sub} prefill ms by prompt length: " + ", ".join(
        f"{n}: {ms:.1f}" for n, ms in sorted(pre_ms)))
    print(f"[{tag}] {sub} decode step {LM_PROFILE_STEP} under the profiler: "
          f"wall {prof['wall']:.2f} ms, device busy {prof['busy']:.2f} ms "
          f"({busy:.1f}%), {prof['events']} device activities; its "
          f"{nbytes / 1e9:.3f} GB at 3.35 TB/s = {bound_ms:.3f} ms bound "
          f"(by {c['step_bound_by']}); median tick {np.median(ticks):.2f} "
          f"ms = {np.median(ticks) / bound_ms:.2f}x the bound")
    print(f"[{tag}] {sub} device: " + "; ".join(
        f"{k[:60]} {ms:.3f} ms" for k, ms in prof["device"]))
    del eng
    return c


def _lm(seed: int, card) -> dict:
    """Phase 12: the LM serving tier on ``card``.  Returns the ``lm``
    line's object."""
    import copy
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import ServeConfig
    rng = np.random.default_rng(seed)
    out = {}

    # 12a: the five smoke configs, card against CPU
    t0 = time.perf_counter()
    out["12a"] = {}
    for name in LM_ARCHS:
        cfg = get_arch(name).smoke_config
        cpu = init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
        gpu = copy.deepcopy(cpu).to(card)
        prompts = [rng.integers(1, cfg.vocab, int(rng.integers(3, 12)))
                   for _ in range(6)]
        row = _lm_forced(cpu, gpu, ServeConfig(max_batch=4, s_cache=64,
                                               max_new_tokens=16),
                         prompts, tol=LM_TOL)
        out["12a"][name] = row
        print(f"[lm] 12a {name}: {row['requests']} requests, "
              f"{row['tokens']} tokens, {row['events']} prefills + steps "
              f"teacher-forced; max |logit card - cpu| "
              f"{row['max_abs_err']:.6f} (tol {LM_TOL}), argmax equal on "
              f"{row['argmax_checked']} of {row['argmax_rows']} rows")
    out["12a_s"] = time.perf_counter() - t0

    # 12b: yi-6b at full width, 2 layers, card against CPU
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_arch("yi-6b").config, n_layers=2)
    cpu = init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    gpu = copy.deepcopy(cpu).to(card)
    n_params = sum(p.numel() for p in cpu.parameters())
    assert n_params == cfg.param_count()
    prompt = rng.integers(1, cfg.vocab, 64)
    row = _lm_forced(cpu, gpu, ServeConfig(max_batch=1, s_cache=128,
                                           max_new_tokens=9), [prompt])
    row.update(params=n_params, layers=cfg.n_layers, prompt=64,
               decode_ticks=8, s=time.perf_counter() - t0)
    out["12b"] = row
    print(f"[lm] 12b yi-6b full width, 2 layers ({n_params:,} params): "
          f"64-token prompt + 8 ticks teacher-forced; max |logit card - "
          f"cpu| {row['max_abs_err']:.6f} (tol 2e-2 x max|logit| "
          f"{row['max_abs_logit']:.4f} = {row['tol']:.6f}), argmax equal "
          f"on {row['argmax_checked']} of {row['argmax_rows']} rows; "
          f"{row['s']:.1f} s")
    del cpu, gpu
    torch.cuda.empty_cache()

    # 12c: yi-6b at full width and depth, on the card
    t0 = time.perf_counter()
    cfg = get_arch("yi-6b").config
    torch.cuda.reset_peak_memory_stats()
    model = init_params(cfg, torch.Generator(card).manual_seed(seed), card)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    assert n_params == cfg.param_count()
    c = {"params": n_params, "weight_bytes": w_bytes, "init_s": t_init}
    with torch.inference_mode():
        toks = torch.from_numpy(rng.integers(1, cfg.vocab, (1, 64))).to(card)
        full, _ = model(toks)
        last, _ = model.prefill(toks)
        gap = float((last - full[:, -1]).abs().max())
        if not torch.allclose(last, full[:, -1], rtol=LM_TOL, atol=LM_TOL):
            raise SystemExit(f"[lm] 12c prefill's last logits differ from "
                             f"forward's by {gap}")
        _, cache63 = model.prefill(toks[:, :-1])
        cache = model.init_cache(1, 128)
        for k, v in cache63.items():
            cache[k][:, :, :63] = v
        step, _ = model.decode_step(toks[:, -1].cpu(), cache,
                                    np.asarray([63], np.int32))
        peak = float(full[:, -1].abs().max())
        dgap = float((step - full[:, -1]).abs().max())
        if not dgap <= LM_TOL * peak:
            raise SystemExit(f"[lm] 12c decode step differs from forward "
                             f"at position 63 by {dgap} > 2e-2 x {peak}")
        if not (torch.isfinite(full).all() and torch.isfinite(step).all()):
            raise SystemExit("[lm] 12c NaN or inf in the logits")
        c.update(prefill_vs_forward=gap, decode_vs_forward=dgap,
                 max_abs_logit=peak, decode_tol=LM_TOL * peak)
        del full, cache, cache63
    print(f"[lm] 12c yi-6b full width and depth ({n_params:,} params, "
          f"{w_bytes / 1e9:.2f} GB) initialised on the card in "
          f"{t_init:.2f} s; gates: prefill == forward at the last position "
          f"(max diff {gap:.6f}), decode step == forward at position 63 "
          f"(max diff {dgap:.6f}, tol {LM_TOL * peak:.6f}), no NaN")

    c.update(_lm_serve(model, rng, card, "lm", "12c"))
    out["12c"] = c
    del model
    torch.cuda.empty_cache()
    return out


def _grid(dev, dd: int, mm: int):
    """A (data, model) mesh whose every entry is ``dev``."""
    import numpy as np
    from repro_torch.distributed import Mesh
    return Mesh(np.full((dd, mm), str(dev), dtype=object), ("data", "model"))


def _placement(n_experts: int, tp: int, pad: bool) -> str:
    if n_experts % tp == 0:
        return "expert parallel"
    return "padded expert parallel" if pad else "TP inside the experts"


def _set_cfg(model, cfg) -> None:
    """Rewire a ``Transformer`` (and its blocks) to ``cfg``: another mesh,
    or none."""
    model.cfg = cfg
    for blk in model.blocks:
        blk.cfg = cfg


@contextlib.contextmanager
def _routes(forced=None):
    """Record each MoE router call's own top-k experts (on the host) while
    the block runs; with ``forced`` (another run's records, call by call)
    the dispatch takes those experts instead, their gates renormalised
    from this run's own, so two runs make the same discrete choices (the
    routing's counterpart of 12a's teacher-forced tokens)."""
    import torch
    from repro_torch.models import moe as MT
    route, rec = MT._route, []

    def recording(xg, router, top_k):
        gates, vals, idx = route(xg, router, top_k)
        rec.append(idx.cpu())
        if forced is None:
            return gates, vals, idx
        idx = forced[len(rec) - 1].to(idx.device)
        vals = torch.gather(gates, -1, idx)
        return gates, vals / vals.sum(dim=-1, keepdim=True), idx

    MT._route = recording
    try:
        yield rec
    finally:
        MT._route = route


def _flips(own, forced) -> list[int]:
    """Tokens whose own top-k set differs from the forced one in some
    router call (a near tie flipped by the bf16 order of the sums)."""
    out = set()
    for a, b in zip(own, forced):
        a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
        out |= {t for t in range(a.shape[0])
                if set(a[t].tolist()) != set(b[t].tolist())}
    return sorted(out)


def _each(rec, n: int) -> list:
    """One run's per-layer router records repeated for the ``n``
    coordinates of a data-1 mesh that each route every token."""
    return [r for r in rec for _ in range(n)]


def _dist(seed: int, card) -> dict:
    """Phase 14: the model rules of distribution on ``card``, every mesh
    of repeated ``cuda:0`` entries.  Returns the ``distribution`` line's
    object."""
    import copy
    import dataclasses
    import math
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.distributed import Mesh
    from repro_torch.distributed.pipeline import (mlp_reference,
                                                  mlp_stage_fn,
                                                  pipeline_apply,
                                                  stack_mlp_params)
    from repro_torch.models.transformer import (Transformer, init_params,
                                                init_params_shape)
    from repro_torch.serve import ServeConfig
    from repro_torch.train.optimizer import compressed_psum_with_feedback
    from repro_torch.train.tree import leaves_with_paths
    rng = np.random.default_rng(seed + 14)
    out = {}

    # 14a: the MoE smoke configs wired to a mesh, card against CPU
    t0 = time.perf_counter()
    out["14a"] = {}
    for name in DIST_ARCHS:
        base = get_arch(name).smoke_config
        for (dd, mm), pad in DIST_SMOKE[name]:
            cfg = dataclasses.replace(base, mesh=_grid("cpu", dd, mm),
                                      dp_spec="data", tp_axis="model",
                                      moe_ep_pad=pad)
            cpu = init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
            gpu = copy.deepcopy(cpu).to(card)
            _set_cfg(gpu, dataclasses.replace(cfg, mesh=_grid(card, dd, mm)))
            toks = torch.from_numpy(rng.integers(0, base.vocab, (2, 16)))
            with torch.inference_mode():
                (lc, ac), (lg, ag) = cpu(toks), gpu(toks.to(card))
            lerr = float((lg.cpu() - lc).abs().max())
            aerr = float((ag.cpu() - ac).abs())
            # the engine's caches evolve on each side, so its gap grows
            # with the steps (one bf16 ulp at the logits' magnitude, as
            # unsharded): gated as 12b, 2e-2 x max|logit|
            prompts = [rng.integers(1, base.vocab, int(rng.integers(3, 12)))
                       for _ in range(6)]
            scfg = ServeConfig(max_batch=4, s_cache=64, max_new_tokens=16)
            row = _lm_forced(cpu, gpu, scfg, prompts)
            # the same engine run unsharded, beside it
            _set_cfg(cpu, base)
            _set_cfg(gpu, base)
            plain = _lm_forced(cpu, gpu, scfg, prompts)["max_abs_err"]
            place = _placement(base.n_experts, mm, pad)
            row.update(mesh=[dd, mm], ep_pad=pad, placement=place,
                       forward_logit_err=lerr, forward_aux_err=aerr,
                       unsharded_engine_err=plain)
            if not (lerr <= LM_TOL and aerr <= LM_TOL):
                raise SystemExit(f"[dist] 14a {name} at {(dd, mm)}: card "
                                 f"logits / aux differ from the CPU's by "
                                 f"{lerr} / {aerr} > {LM_TOL}")
            out["14a"][f"{name} {dd}x{mm}{' ep_pad' if pad else ''}"] = row
            print(f"[dist] 14a {name} mesh (data={dd}, model={mm})"
                  f"{' ep_pad' if pad else ''}: {place}; forward max |logit "
                  f"card - cpu| {lerr:.6f}, aux {aerr:.2e}; engine "
                  f"{row['requests']} requests, {row['events']} prefills + "
                  f"steps teacher-forced, max |logit| err "
                  f"{row['max_abs_err']:.6f} (tol 2e-2 x "
                  f"{row['max_abs_logit']:.4f} = {row['tol']:.6f}; "
                  f"unsharded on the same prompts {plain:.6f})")
    out["14a_s"] = time.perf_counter() - t0

    # 14b: both MoE archs at full width, cut to DIST_LAYERS layers, on the
    # production model axis; granite's EP and TP-inside layouts against
    # the unsharded model too
    out["14b"] = {}
    for name in DIST_ARCHS:
        t0 = time.perf_counter()
        full = get_arch(name).config
        base = dataclasses.replace(full, n_layers=DIST_LAYERS)
        cfg = dataclasses.replace(base, mesh=_grid(card, 1, DIST_TP),
                                  dp_spec="data", tp_axis="model")
        gpu = init_params(cfg, torch.Generator(card).manual_seed(seed), card)
        n_params = sum(p.numel() for p in gpu.parameters())
        cpu = Transformer(dataclasses.replace(
            cfg, mesh=_grid("cpu", 1, DIST_TP)), "cpu")
        cpu.load_state_dict(gpu.state_dict())
        toks = torch.from_numpy(rng.integers(1, base.vocab,
                                             (1, DIST_TOKENS)))
        with torch.inference_mode(), _routes() as recc:
            lc, ac = cpu(toks)
        del cpu
        with torch.inference_mode(), _routes(recc) as recg:
            lg, ag = gpu(toks.to(card))
        peak = float(lc.abs().max())
        err = float((lg.cpu() - lc).abs().max())
        flips = _flips(recg, recc)
        row = dict(params=n_params, layers=DIST_LAYERS,
                   placement=_placement(base.n_experts, DIST_TP, False),
                   max_abs_err=err, max_abs_logit=peak, tol=LM_TOL * peak,
                   routing_flips=flips, aux_card=float(ag),
                   aux_cpu=float(ac))
        if not err <= LM_TOL * peak:
            raise SystemExit(f"[dist] 14b {name}: card logits differ from "
                             f"the CPU's by {err} > 2e-2 x {peak}")
        print(f"[dist] 14b {name} full width, {DIST_LAYERS} layers "
              f"({n_params:,} params), mesh (data=1, model={DIST_TP}): "
              f"{row['placement']}; {DIST_TOKENS} tokens, the card routed "
              f"as the CPU: max |logit card - cpu| {err:.6f} (tol 2e-2 x "
              f"{peak:.4f} = {LM_TOL * peak:.6f}); tokens whose own top-k "
              f"set differed on the card (named): {flips}; aux card "
              f"{float(ag):.6f} cpu {float(ac):.6f}")
        if name == DIST_ARCHS[0]:
            _set_cfg(gpu, dataclasses.replace(base, moe_groups=1))
            with torch.inference_mode(), _routes() as rec1:
                lp, _ = gpu(toks.to(card))
            tol = LM_TOL * float(lp.abs().max())
            for tag, mm in (("ep_model8", 8), ("tp_inside_model16", DIST_TP)):
                _set_cfg(gpu, dataclasses.replace(
                    cfg, mesh=_grid(card, 1, mm)))
                with torch.inference_mode(), \
                        _routes(_each(rec1, mm)) as recx:
                    lx, _ = gpu(toks.to(card))
                e = float((lx - lp).abs().max())
                fl = _flips(recx, _each(rec1, mm))
                row[f"{tag}_vs_unsharded"] = dict(max_abs_err=e, tol=tol,
                                                  routing_flips=fl)
                print(f"[dist] 14b {name} {tag} vs unsharded moe_ffn "
                      f"(moe_groups=1), routed as the unsharded run: max "
                      f"|logit diff| {e:.6f} (tol {tol:.6f}); tokens whose "
                      f"own top-k set differed (named): {fl}")
                if not e <= tol:
                    raise SystemExit(f"[dist] 14b {name} {tag}: logits "
                                     f"differ from the unsharded model's by "
                                     f"{e} > {tol}")
        row["s"] = time.perf_counter() - t0
        out["14b"][name] = row
        del gpu
        torch.cuda.empty_cache()

    # 14c: granite at full width and depth over (data=2, model=16)
    t0 = time.perf_counter()
    full = get_arch(DIST_ARCHS[0]).config
    cfg = dataclasses.replace(full, mesh=_grid(card, *DIST_MESH),
                              dp_spec="data", tp_axis="model")
    torch.cuda.reset_peak_memory_stats()
    model = init_params(cfg, torch.Generator(card).manual_seed(seed), card)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    assert n_params == full.param_count()
    c = {"params": n_params, "weight_bytes": w_bytes,
         "mesh": list(DIST_MESH),
         "placement": _placement(full.n_experts, DIST_MESH[1], False),
         "init_s": time.perf_counter() - t0}
    # The gates run dropless (capacity factor E / k: every expert can take
    # every token of its data shard).  At the config's 1.25 a token's
    # output depends on the batch it is dispatched in (GShard capacity):
    # the 64-token forward shards 32 tokens a data shard (capacity 8), the
    # 63-token prefill is replicated (capacity 15) and the decode step
    # dispatches one token (capacity 1), so the tokens each drops differ;
    # that gap is printed, not gated.
    toks = torch.from_numpy(rng.integers(1, full.vocab, (1, 64))).to(card)

    def gates():
        with torch.inference_mode():
            logits, _ = model(toks)
            last, _ = model.prefill(toks)
            _, cache63 = model.prefill(toks[:, :-1])
            cache = model.init_cache(1, 128)
            for key, v in cache63.items():
                cache[key][:, :, :63] = v
            step, _ = model.decode_step(toks[:, -1].cpu(), cache,
                                        np.asarray([63], np.int32))
        finite = bool(torch.isfinite(logits).all()
                      and torch.isfinite(step).all())
        return (float((last - logits[:, -1]).abs().max()),
                float((step - logits[:, -1]).abs().max()),
                float(logits[:, -1].abs().max()), finite)

    _set_cfg(model, dataclasses.replace(
        cfg, capacity_factor=full.n_experts / full.top_k))
    gap, dgap, peak, finite = gates()
    _set_cfg(model, cfg)
    gap_cf, dgap_cf, _, finite_cf = gates()
    if not gap <= LM_TOL:
        raise SystemExit(f"[dist] 14c prefill's last logits differ from "
                         f"forward's by {gap}")
    if not dgap <= LM_TOL * peak:
        raise SystemExit(f"[dist] 14c decode step differs from forward "
                         f"at position 63 by {dgap} > 2e-2 x {peak}")
    if not (finite and finite_cf):
        raise SystemExit("[dist] 14c NaN or inf in the logits")
    c.update(prefill_vs_forward=gap, decode_vs_forward=dgap,
             max_abs_logit=peak, decode_tol=LM_TOL * peak,
             gate_capacity_factor=full.n_experts / full.top_k,
             prefill_vs_forward_cf=gap_cf, decode_vs_forward_cf=dgap_cf)
    print(f"[dist] 14c {full.name} full width and depth ({n_params:,} "
          f"params, {w_bytes / 1e9:.2f} GB) on mesh (data={DIST_MESH[0]}, "
          f"model={DIST_MESH[1]}), {c['placement']}; gates (dropless, "
          f"capacity factor {full.n_experts / full.top_k:g}): prefill == "
          f"forward at the last position (max diff {gap:.6f}), decode step "
          f"== forward at position 63 (max diff {dgap:.6f}, tol "
          f"{LM_TOL * peak:.6f}), no NaN; at the config's capacity factor "
          f"{full.capacity_factor}: {gap_cf:.6f} and {dgap_cf:.6f} (not "
          f"gated: capacity drops differ by batch)")
    c["meshed"] = _lm_serve(model, np.random.default_rng(seed + 140), card,
                            "dist", "14c meshed", **DIST_SERVE)
    _set_cfg(model, full)
    torch.cuda.reset_peak_memory_stats()
    c["unsharded"] = _lm_serve(model, np.random.default_rng(seed + 140),
                               card, "dist", "14c unsharded", **DIST_SERVE)
    c["s"] = time.perf_counter() - t0
    out["14c"] = c
    del model
    torch.cuda.empty_cache()

    # 14d: the compressed gradient psum over a data axis of PSUM_SHARDS,
    # yi-6b's leaves of one layer plus embed and unembed (and ln_f)
    t0 = time.perf_counter()
    shapes = [(p, tuple(v.shape)) for p, v in leaves_with_paths(
        init_params_shape(dataclasses.replace(get_arch("yi-6b").config,
                                              n_layers=1)))]
    n_el = sum(math.prod(sh) for _, sh in shapes)
    mesh_g, mesh_c = Mesh([card] * PSUM_SHARDS), Mesh(["cpu"] * PSUM_SHARDS)
    gen = torch.Generator(card).manual_seed(seed)
    errs_g, errs_c = ([{p: torch.zeros(sh, device=dev) for p, sh in shapes}
                       for _ in range(PSUM_SHARDS)] for dev in (card, "cpu"))
    card_ms, cpu_s, worst = [], [], 0.0
    for t in range(PSUM_STEPS):
        grads = [{p: (torch.randn(sh, generator=gen, device=card)
                      * (1e-3 * (i + 1) ** 2)).to(torch.bfloat16)
                  for p, sh in shapes} for i in range(PSUM_SHARDS)]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        red, new_e = compressed_psum_with_feedback(grads, errs_g, "data",
                                                   mesh_g)
        torch.cuda.synchronize()
        card_ms.append((time.perf_counter() - t1) * 1e3)
        for p, _ in shapes:      # out + sum(new_e) == sum(target)
            tg = [g[p].float() + e[p] for g, e in zip(grads, errs_g)]
            lhs = red[0][p] + sum(e[p] for e in new_e)
            mag = red[0][p].abs() + sum(e[p].abs() + x.abs()
                                        for e, x in zip(new_e, tg))
            gap = (lhs - sum(tg)).abs()
            if not bool((gap <= 8 * 2.0 ** -24 * mag).all()):
                raise SystemExit(f"[dist] 14d step {t} {p}: out + sum(new_e)"
                                 f" != sum(target) beyond float32 rounding")
            worst = max(worst, float((gap / mag.clamp(min=1e-30)).max()))
            del tg, lhs, mag, gap
        errs_g = new_e
        grads_c = [{p: v.cpu() for p, v in g.items()} for g in grads]
        del grads
        t1 = time.perf_counter()
        red_c, new_c = compressed_psum_with_feedback(grads_c, errs_c,
                                                     "data", mesh_c)
        cpu_s.append(time.perf_counter() - t1)
        for i in range(PSUM_SHARDS):
            for p, _ in shapes:
                if not (torch.equal(red[i][p].cpu(), red_c[i][p])
                        and torch.equal(new_e[i][p].cpu(), new_c[i][p])):
                    raise SystemExit(f"[dist] 14d step {t} shard {i} {p}: "
                                     f"the card differs from the CPU")
        errs_c = new_c
        del red, red_c, grads_c
    nbytes = n_el * PSUM_SHARDS * (2 + 4 + 4 + 4)
    out["14d"] = dict(leaves=len(shapes), elements_per_shard=n_el,
                      shards=PSUM_SHARDS, steps=PSUM_STEPS, card_ms=card_ms,
                      cpu_s=cpu_s, bytes=nbytes,
                      bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                      worst_rel_closure=worst,
                      s=time.perf_counter() - t0)
    print(f"[dist] 14d compressed_psum_with_feedback over data={PSUM_SHARDS}"
          f": {len(shapes)} yi-6b leaves, {n_el:,} elements a shard, "
          f"{PSUM_STEPS} carried steps; card == cpu bit for bit; out + "
          f"sum(new_e) == sum(target) within float32 rounding (worst "
          f"{worst:.2e} of the terms); card ms per call "
          + ", ".join(f"{v:.2f}" for v in card_ms)
          + f" against a {nbytes / 1e9:.2f} GB bound of "
          f"{nbytes / HBM_BYTES_PER_S * 1e3:.2f} ms; cpu s per call "
          + ", ".join(f"{v:.1f}" for v in cpu_s))
    del errs_g, errs_c, new_e, new_c
    torch.cuda.empty_cache()

    # 14e: GPipe over a stage mesh of 4 on the card, against mlp_reference.
    # The forward is held in float32.  The float32 gradients are not a
    # well-posed gate at this depth: a pre-activation within rounding of
    # zero turns its relu on or off between any two orders of summation,
    # so mlp_reference itself, on the CPU or the card, differs from a
    # float64 evaluation by up to ~6e-3 of a layer's max |dW|; they are
    # printed, and the gradients are held in float64, where the schedule's
    # own error shows.
    t0 = time.perf_counter()
    S, Lg, d = GPIPE["stages"], GPIPE["layers"], GPIPE["d"]
    B, M = GPIPE["batch"], GPIPE["micro"]
    gen = torch.Generator(card).manual_seed(seed)
    params = stack_mlp_params(gen, Lg, d, device=card)
    x = torch.randn((B, d), generator=gen, device=card)
    mesh = Mesh([card] * S, ("stage",))

    def pipe(p, xx):
        return pipeline_apply(mesh, "stage", M, mlp_stage_fn, p, xx)

    def fwd_bwd(fn, dtype=torch.float32):
        p = {k: v.detach().to(dtype, copy=True).requires_grad_()
             for k, v in params.items()}
        xx = x.to(dtype, copy=True).requires_grad_()
        y = fn(p, xx)
        (y ** 2).sum().backward()
        return y.detach(), p["w"].grad, p["b"].grad, xx.grad

    def timed(fn) -> float:
        fwd_bwd(fn)
        ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fwd_bwd(fn)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
        return float(np.median(ms))

    names = ("y", "grad_w", "grad_b", "grad_x")

    def compare(got, want) -> dict:
        return {nm: dict(max_abs_err=float((a - b).abs().max()),
                         excess=float(((a - b).abs() - tol * b.abs()).max()
                                      - tol),
                         rel_to_max=float((a - b).abs().max()
                                          / b.abs().max()))
                for nm, a, b, tol in zip(names, got, want,
                                         (1e-5, 1e-4, 1e-4, 1e-4))}

    ref32, ref64 = fwd_bwd(mlp_reference), fwd_bwd(mlp_reference,
                                                     torch.float64)
    f32 = compare(fwd_bwd(pipe), ref32)
    f64 = compare(fwd_bwd(pipe, torch.float64), ref64)
    ref_conditioning = {nm: float((a.double() - b).abs().max()
                                  / b.abs().max())
                        for nm, a, b in zip(names, ref32, ref64)}
    del ref32, ref64
    if not f32["y"]["excess"] <= 0:
        raise SystemExit(f"[dist] 14e pipeline_apply's float32 forward "
                         f"differs from mlp_reference's: {f32['y']}")
    bad = [nm for nm in names if not f64[nm]["excess"] <= 0]
    if bad:
        raise SystemExit(f"[dist] 14e pipeline_apply's float64 "
                         f"{', '.join(bad)} differ from mlp_reference's "
                         f"beyond 1e-5 / 1e-4: {f64}")
    pipe_ms, ref_ms = timed(pipe), timed(mlp_reference)
    out["14e"] = dict(stages=S, layers=Lg, d=d, batch=B, micro=M,
                      float32=f32, float64=f64,
                      reference_f32_vs_f64=ref_conditioning, pipe_ms=pipe_ms,
                      ref_ms=ref_ms, work_ratio=(M + S - 1) / M,
                      tf32=torch.backends.cuda.matmul.allow_tf32,
                      s=time.perf_counter() - t0)
    print(f"[dist] 14e pipeline_apply over stage={S}, L={Lg}, d={d}, B={B},"
          f" M={M}: float32 forward within 1e-5 of mlp_reference (max |diff| "
          f"{f32['y']['max_abs_err']:.2e}); float64 forward and gradients "
          f"within 1e-5 / 1e-4 (max |diff| / max " + ", ".join(
              f"{k} {v['rel_to_max']:.1e}" for k, v in f64.items())
          + "); float32 gradients (relu kinks, printed) max |diff| / max "
          + ", ".join(f"{k} {f32[k]['rel_to_max']:.1e}" for k in names[1:])
          + "; mlp_reference itself, float32 against float64: "
          + ", ".join(f"{k} {v:.1e}" for k, v in ref_conditioning.items())
          + f"; float32 fwd+bwd {pipe_ms:.2f} ms against mlp_reference's "
          f"{ref_ms:.2f} ms ({pipe_ms / ref_ms:.2f}x; (M+S-1)/M = "
          f"{(M + S - 1) / M:.3f})")
    del params, x
    torch.cuda.empty_cache()
    return out


def _drive(tr, steps: int) -> list[dict]:
    """``steps`` steps of ``tr`` as ``Trainer.run`` takes them (the next
    batch, ``step_fn``, a synchronise of the device, the host clock around
    both), without its checkpoints: at full width a save writes the whole
    state to disk (10.4 GB at 13b's size).  Returns the history."""
    import torch
    hist = []
    for step in range(steps):
        batch = {k: torch.from_numpy(v).to(tr.device)
                 for k, v in tr.pipeline.next_batch().items()}
        t0 = time.perf_counter()
        tr.params, tr.opt_state, metrics = tr.step_fn(tr.params,
                                                      tr.opt_state, batch)
        if tr.device.type == "cuda":
            torch.cuda.synchronize(tr.device)
        hist.append({"step": step, "time_s": time.perf_counter() - t0,
                     **{k: float(v) for k, v in metrics.items()}})
    return hist


def _train_pair(cpu, card, data: dict, steps: int, ocfg: dict,
                run: bool = True) -> dict:
    """``steps`` ``Trainer`` steps of the model ``cpu`` on the CPU and of
    its copy ``card`` on the card, on the same pipeline (through
    ``Trainer.run``, or ``_drive`` when ``run`` is False).  Gates: the loss
    and the global grad norm of each step within ``TRAIN_TOL`` relative;
    for one step from the same parameters, its gradients within
    ``TRAIN_TOL`` × the CPU leaf's max |g| (after more, the last step's are
    reported); every parameter after it within ``TRAIN_TOL`` × the CPU
    leaf's max |p|, but for an element whose two last gradients differ in
    sign, both within ``TRAIN_TOL`` × max |g| of zero (inside the
    gradients' own tolerance): Adam's sign-like steps then go opposite
    ways by up to ``lr`` each, and the element is held within that
    tolerance plus ``2 · lr`` (their count and largest |g| are returned).
    Returns the largest relative errors."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch.data import (DataConfig, ShardedTokenPipeline,
                                  SyntheticLMDataset)
    from repro_torch.models.convert import lm_params_to_numpy
    from repro_torch.train import loop
    from repro_torch.train.loop import Trainer, TrainConfig
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.tree import Stacked, leaves_with_paths, parts
    hists, grads = [], []
    update = loop.adamw_update

    def snapshot(cfg, params, g, state):
        last.clear()
        for path, leaf in leaves_with_paths(params):
            ts = [p.grad if p.grad is not None else torch.zeros_like(p)
                  for p in parts(leaf)]
            t = torch.stack(ts) if isinstance(leaf, Stacked) else ts[0]
            last[path] = t.float().cpu().numpy()
        return update(cfg, params, g, state)

    for model in (cpu, card):
        last: dict = {}
        loop.adamw_update = snapshot
        try:
            with tempfile.TemporaryDirectory(prefix="train_") as d, \
                    contextlib.redirect_stdout(io.StringIO()):
                tr = Trainer(_lm_train_loss, model, ShardedTokenPipeline(
                    SyntheticLMDataset(DataConfig(**data))),
                    opt_cfg=AdamWConfig(**ocfg), train_cfg=TrainConfig(
                        total_steps=steps, ckpt_every=10 ** 9, ckpt_dir=d,
                        log_every=10 ** 9))
                hists.append(tr.run(resume=False) if run
                             else _drive(tr, steps))
                del tr
        finally:
            loop.adamw_update = update
        grads.append(last)
    row = dict(steps=steps, loss_cpu=[h["loss"] for h in hists[0]],
               loss_card=[h["loss"] for h in hists[1]])
    for key in ("loss", "grad_norm"):
        errs = [abs(g[key] - c[key]) / abs(c[key])
                for c, g in zip(*hists)]
        if not all(np.isfinite(g[key]) for g in hists[1]) \
                or max(errs) > TRAIN_TOL:
            raise SystemExit(f"[train] card {key} differs from the CPU's by "
                             f"{max(errs)} relative > {TRAIN_TOL}")
        row[f"{key}_rel_err"] = max(errs)
    lr = max(h["lr"] for h in hists[0])
    worst = dict(grad=0.0, param=0.0, flipped=0, flipped_max_g=0.0,
                 elements=0)
    on_card = dict(leaves_with_paths(lm_params_to_numpy(card)))
    for path, a in leaves_with_paths(lm_params_to_numpy(cpu)):
        b, gc, gg = on_card[path], grads[0][path], grads[1][path]
        gerr = float(np.abs(gg - gc).max()) / max(float(np.abs(gc).max()),
                                                  1e-30)
        if steps == 1 and gerr > TRAIN_TOL:
            raise SystemExit(f"[train] card gradient {path} differs from "
                             f"the CPU's by {gerr} x its max |g| > "
                             f"{TRAIN_TOL}")
        tol = TRAIN_TOL * max(float(np.abs(a).max()), 1e-30)
        g_tol = TRAIN_TOL * float(np.abs(gc).max())
        diff = np.abs(a - b)
        beyond = diff > tol
        flipped = beyond & (np.sign(gc) != np.sign(gg)) \
            & (np.abs(gc) <= g_tol) & (np.abs(gg) <= g_tol) \
            & (diff <= tol + 2 * lr)
        if not np.isfinite(b).all() or (beyond & ~flipped).any():
            raise SystemExit(f"[train] card parameter {path} differs from "
                             f"the CPU's by {float(diff.max())} (tol {tol}; "
                             f"tol + 2 lr where the gradients differ in "
                             f"sign within {g_tol} of zero)")
        worst["grad"] = max(worst["grad"], gerr)
        worst["param"] = max(worst["param"], float(diff.max()) * TRAIN_TOL
                             / tol)
        worst["flipped"] += int(flipped.sum())
        worst["elements"] += int(diff.size)
        if flipped.any():
            worst["flipped_max_g"] = max(
                worst["flipped_max_g"], float(np.abs(gc[flipped]).max()),
                float(np.abs(gg[flipped]).max()))
    row.update(grad_rel_err=worst["grad"], param_rel_err=worst["param"],
               sign_flips=worst["flipped"], elements=worst["elements"],
               sign_flip_max_abs_grad=worst["flipped_max_g"], lr=lr)
    return row


def _step_parts(tr, batch) -> dict:
    """One more step of ``tr`` on ``batch``, taken apart as the train step
    takes it — the loss (forward), ``backward`` (each layer recomputed),
    ``adamw_update`` — with a synchronise after each: host ms of each part;
    and the two float32 products of the logits' backward
    (``_MatmulF32.backward``) alone, on the step's shapes, timed with CUDA
    events over 3 calls."""
    import torch
    from repro_torch.train import loop
    from repro_torch.train.optimizer import adamw_update
    ms, marks = {}, [time.perf_counter()]

    def mark(name):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        ms[name] = (marks[-1] - marks[-2]) * 1e3

    torch.cuda.synchronize()
    marks[0] = time.perf_counter()
    loss = _lm_train_loss(tr.params, batch)
    mark("forward")
    loss.backward()
    mark("backward")
    tr.params, tr.opt_state, _ = adamw_update(tr.opt_cfg, tr.params, None,
                                              tr.opt_state)
    mark("adamw_update")
    loop._clear_grads(tr.params)
    ms["loss"] = float(loss.detach())
    model = tr.params
    x = torch.randn((batch["tokens"].numel(), model.cfg.d_model),
                    device=model.device).to(torch.bfloat16)
    g = torch.randn((x.shape[0], model.cfg.padded_vocab),
                    device=model.device)
    w = model.unembed.detach()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(3):
        torch.mm(g, w.float().t()).to(x.dtype)
        torch.mm(x.float().t(), g).to(w.dtype)
    stop.record()
    torch.cuda.synchronize()
    ms["logits_backward_f32_products"] = start.elapsed_time(stop) / 3
    return ms


def _lm_train_loss(model, batch):
    return model.lm_loss(batch["tokens"], batch["targets"])


def _train_flops(cfg, n_params: int, tokens: int, seq: int) -> tuple:
    """Model FLOPs of one training step: 6 × params × tokens, plus the
    attention's score and value products, 12 × layers × heads × head_dim
    × seq per token (forward and backward, causal masking not
    discounted).  Returns (flops, the formula as a string)."""
    att = 12 * cfg.n_layers * cfg.n_heads * cfg.head_dim * seq
    return (6 * n_params * tokens + att * tokens,
            f"6 * {n_params} * {tokens} + 12 * {cfg.n_layers} * "
            f"{cfg.n_heads} * {cfg.head_dim} * {seq} * {tokens}")


def _train(seed: int, card) -> dict:
    """Phase 13: the training tier on ``card``.  Returns the ``train``
    line's object."""
    import copy
    import dataclasses
    import tempfile
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data import (DataConfig, ShardedTokenPipeline,
                                  SyntheticLMDataset)
    from repro_torch.launch import train as launch_train
    from repro_torch.launch import web_graph
    from repro_torch.models.transformer import init_params
    from repro_torch.train.loop import Trainer, TrainConfig
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.tree import leaves, parts
    out = {}

    # 13a: the five smoke configs, TRAIN_STEPS steps, card against CPU
    t0 = time.perf_counter()
    out["13a"] = {}
    for name in LM_ARCHS:
        cfg = get_arch(name).smoke_config
        cpu = init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
        gpu = copy.deepcopy(cpu).to(card)
        row = _train_pair(cpu, gpu, dict(seq_len=32, global_batch=8,
                                         vocab=cfg.vocab, seed=seed),
                          TRAIN_STEPS, TRAIN_OPT)
        out["13a"][name] = row
        print(f"[train] 13a {name}: {TRAIN_STEPS} Trainer steps, card vs "
              f"cpu: loss {row['loss_cpu'][0]:.4f} -> "
              f"{row['loss_cpu'][-1]:.4f}, max rel err loss "
              f"{row['loss_rel_err']:.2e}, grad norm "
              f"{row['grad_norm_rel_err']:.2e}, grads "
              f"{row['grad_rel_err']:.2e} x max|g|, params "
              f"{row['param_rel_err']:.2e} x max|p| (tol {TRAIN_TOL}; "
              f"{row['sign_flips']} of {row['elements']} elements past it, "
              f"each with gradients of other signs, |g| <= "
              f"{row['sign_flip_max_abs_grad']:.1e}, within tol + 2 lr)")
    out["13a_s"] = time.perf_counter() - t0

    # 13b: yi-6b at full width, 2 layers: one step card vs CPU at seq 128,
    # then timed steps on the card at train_4k's sequence length, batch 1
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_arch("yi-6b").config, n_layers=2)
    cpu = init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    gpu = copy.deepcopy(cpu).to(card)
    n_params = sum(p.numel() for p in cpu.parameters())
    assert n_params == cfg.param_count()
    row = _train_pair(cpu, gpu, dict(seq_len=128, global_batch=1,
                                     vocab=cfg.vocab, seed=seed), 1,
                      TRAIN_OPT, run=False)
    del cpu
    print(f"[train] 13b yi-6b full width, 2 layers ({n_params:,} params): "
          f"one step at seq 128 card vs cpu: loss {row['loss_cpu'][0]:.4f}, "
          f"rel err loss {row['loss_rel_err']:.2e}, grad norm "
          f"{row['grad_norm_rel_err']:.2e}, grads {row['grad_rel_err']:.2e} "
          f"x max|g|, params {row['param_rel_err']:.2e} x max|p| (tol "
          f"{TRAIN_TOL}; {row['sign_flips']} of {row['elements']} elements "
          f"past it, each with gradients of other signs, |g| <= "
          f"{row['sign_flip_max_abs_grad']:.1e}, within tol + 2 lr); "
          f"{time.perf_counter() - t0:.1f} s")
    b = dict(params=n_params, layers=cfg.n_layers, check=row,
             check_s=time.perf_counter() - t0, seq=TRAIN_SEQ, batch=1)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="train_") as d:
        pipe = ShardedTokenPipeline(SyntheticLMDataset(DataConfig(
            seq_len=TRAIN_SEQ, global_batch=1, vocab=cfg.vocab, seed=seed)))
        tr = Trainer(_lm_train_loss, gpu, pipe, opt_cfg=AdamWConfig(
            **TRAIN_OPT), train_cfg=TrainConfig(
                total_steps=TRAIN_TIMED, ckpt_dir=d))
        hist = _drive(tr, TRAIN_TIMED)
    step_ms = [h["time_s"] * 1e3 for h in hist]
    mem = torch.cuda.max_memory_allocated()
    state = sum(p.numel() * p.element_size() * 2 for leaf in leaves(gpu)
                for p in parts(leaf)) + sum(
        t.numel() * 4 for t in leaves(tr.opt_state.mu)) * 2
    batch = {k: torch.from_numpy(v).to(card)
             for k, v in pipe.next_batch().items()}
    res = []
    prof = _lm_busy(lambda: res.append(tr.step_fn(tr.params, tr.opt_state,
                                                  batch)))
    loss_prof = float(res[0][2]["loss"])
    parts_ms = _step_parts(tr, batch)
    losses = [h["loss"] for h in hist] + [loss_prof, parts_ms.pop("loss")]
    if not all(np.isfinite(x) for x in losses):
        raise SystemExit(f"[train] 13b non-finite loss: {losses}")
    flops, formula = _train_flops(cfg, n_params, TRAIN_SEQ, TRAIN_SEQ)
    med = float(np.median(step_ms))
    busy = 100 * prof["busy"] / prof["wall"]
    b.update(step_ms=step_ms, step_ms_median=med,
             tokens_per_s=TRAIN_SEQ / (med / 1e3), losses=losses,
             max_memory_allocated=mem, state_bytes=state,
             profiled_step=dict(wall_ms=prof["wall"], busy_ms=prof["busy"],
                                busy_pct=busy, device_activities=prof[
                                    "events"], top=prof["device"]),
             step_parts_ms=parts_ms, model_flops=flops,
             model_flops_formula=formula,
             model_tflops_per_s=flops / (med / 1e3) / 1e12,
             mfu_pct=100 * flops / (med / 1e3) / H100_BF16_FLOPS,
             timed_s=time.perf_counter() - t1,
             reduced=["2 of 32 layers (the whole model's state, 12 bytes "
                      "a parameter, is 72.7 GB of the card's 80)",
                      "train_4k's global batch 256 cut to 1"])
    out["13b"] = b
    print(f"[train] 13b {TRAIN_TIMED} steps on the card at seq {TRAIN_SEQ}, "
          f"batch 1 (train_4k cut: 2 of 32 layers, batch 1 of 256): step ms "
          + ", ".join(f"{x:.1f}" for x in step_ms) + f"; median {med:.1f} "
          f"ms = {TRAIN_SEQ / (med / 1e3):.0f} tokens/s; loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    print(f"[train] 13b max_memory_allocated {mem / 1e9:.2f} GB (state: "
          f"bf16 weights and grads, f32 mu and nu, {state / 1e9:.2f} GB); "
          f"model FLOPs per step {formula} = {flops / 1e12:.2f} TFLOP -> "
          f"{b['model_tflops_per_s']:.1f} TFLOP/s at the median step, "
          f"{b['mfu_pct']:.2f}% of the H100's 989 TFLOP/s dense bf16 peak")
    print("[train] 13b one more step in parts (a synchronise after each; "
          "host ms): " + ", ".join(f"{k} {v:.1f}" for k, v in
                                   parts_ms.items()))
    print(f"[train] 13b one step under the profiler: wall "
          f"{prof['wall']:.1f} ms, device busy {prof['busy']:.1f} ms "
          f"({busy:.1f}%), {prof['events']} device activities; "
          + "; ".join(f"{k[:60]} {ms:.2f} ms" for k, ms in prof["device"]))
    del tr, gpu, res, batch
    torch.cuda.empty_cache()
    out["13b_s"] = time.perf_counter() - t0

    # 13c: crash-exact resume on the card, deterministic algorithms on
    t0 = time.perf_counter()
    cfg = get_arch("yi-6b").smoke_config
    data = dict(seq_len=32, global_batch=8, vocab=cfg.vocab, seed=seed)

    def trainer(d, init_seed):
        model = init_params(cfg, torch.Generator(card).manual_seed(init_seed),
                            card)
        return Trainer(_lm_train_loss, model, ShardedTokenPipeline(
            SyntheticLMDataset(DataConfig(**data))), opt_cfg=AdamWConfig(
                lr=1e-3, warmup_steps=2, total_steps=6),
            train_cfg=TrainConfig(total_steps=6, ckpt_every=10 ** 9,
                                  ckpt_dir=d, log_every=10 ** 9))

    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory(prefix="train_") as d, \
                contextlib.redirect_stdout(io.StringIO()):
            straight = trainer(f"{d}/a", seed)
            h_straight = straight.run()
            first = trainer(f"{d}/b", seed)
            h_first = first.run(steps=3)
            saved = first.ckpt.steps()
            resumed = trainer(f"{d}/b", seed + 1)
            h_resumed = resumed.run()
    finally:
        torch.use_deterministic_algorithms(False)
    loss_a = [h["loss"] for h in h_straight]
    loss_b = [h["loss"] for h in h_first + h_resumed]
    same = [torch.equal(x, y) for x, y in zip(
        [p for leaf in leaves(straight._state()) for p in parts(leaf)],
        [p for leaf in leaves(resumed._state()) for p in parts(leaf)])]
    if saved != [3] or [h["step"] for h in h_resumed] != [3, 4, 5] \
            or loss_a != loss_b or not all(same):
        raise SystemExit(f"[train] 13c resume is not exact: checkpoints "
                         f"{saved}, losses {loss_a} vs {loss_b}, "
                         f"{same.count(False)} of {len(same)} state tensors "
                         f"differ")
    out["13c"] = dict(losses=loss_a, state_tensors=len(same),
                      s=time.perf_counter() - t0)
    print(f"[train] 13c yi-6b smoke: 6 steps straight == 3 steps, save, "
          f"a fresh Trainer restores, 3 more steps: losses equal bit for "
          f"bit ({loss_a[0]:.6f} -> {loss_a[-1]:.6f}), all {len(same)} "
          f"parameter and optimizer tensors equal, under "
          f"torch.use_deterministic_algorithms(True)")

    # 13d: launch/train.py --smoke --arch yi-6b --steps 20 on the card.
    # Each step's loss is that of another batch: over 20 steps at lr 1e-3
    # the batches' spread outweighs the gain (the reference's own smoke
    # ends above its start), so the gate compares like with like: the
    # trained model's loss on the first step's batch against that step's
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="train_") as d:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            tr = launch_train.main(["--smoke", "--arch", "yi-6b",
                                    "--steps", "20", "--ckpt-dir", d])
    hist, lines = tr.history, buf.getvalue().splitlines()
    first = {k: torch.from_numpy(v).to(card) for k, v in
             tr.pipeline.dataset.batch_at(0).items()}
    with torch.no_grad():
        after = float(tr.params.lm_loss(first["tokens"], first["targets"]))
    if len(hist) != 20 or tr.device != card or not after < hist[0]["loss"]:
        raise SystemExit(f"[train] 13d the smoke run's loss on its first "
                         f"batch did not fall: {hist[0]['loss']} -> {after} "
                         f"({lines[-1]})")
    out["13d"] = dict(first=hist[0]["loss"], last=hist[-1]["loss"],
                      first_batch_after=after,
                      step_ms_median=float(np.median(
                          [h["time_s"] * 1e3 for h in hist[1:]])),
                      s=time.perf_counter() - t0)
    print(f"[train] 13d launch/train.py --smoke --arch yi-6b --steps 20 on "
          f"the card: {lines[0]}; {lines[-1]}; the first step's batch: loss "
          f"{hist[0]['loss']:.4f} before, {after:.4f} after the 20 steps; "
          f"median step {out['13d']['step_ms_median']:.2f} ms")
    del tr

    # 13e: the web_graph flow on the card, against the CPU
    t0 = time.perf_counter()
    runs = {}
    for dev in ("cpu", card):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            web_graph.main(device=dev)
        runs[str(dev)] = buf.getvalue().splitlines()
    lines_c, lines_g = runs["cpu"], runs[str(card)]
    if lines_g != lines_c or lines_g[-1] != "web_graph OK":
        raise SystemExit(f"[train] 13e the web_graph flow printed other "
                         f"lines on the card: {lines_g} vs {lines_c}")
    adj = web_graph.make_web_graph(600)
    src = np.repeat(np.arange(600), [len(a) for a in adj])
    dst = np.concatenate(adj)
    from repro_torch.models import gnn
    params = gnn.init_params(web_graph.GCN, torch.Generator().manual_seed(
        seed))
    feats = np.random.default_rng(seed).normal(
        size=(600, web_graph.GCN.d_feat)).astype(np.float32)
    want = web_graph.gcn_logits(params, feats, src, dst, "cpu")
    got = web_graph.gcn_logits({k: [t.to(card) for t in v]
                                for k, v in params.items()}, feats, src,
                               dst, card).cpu()
    gerr = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=1e-5, atol=1e-5):
        raise SystemExit(f"[train] 13e GCN logits on the card differ from "
                         f"the CPU's by {gerr}")
    out["13e"] = dict(lines=lines_g[:3], gcn_max_abs_err=gerr,
                      s=time.perf_counter() - t0)
    print(f"[train] 13e launch/web_graph.py on the card == on the CPU: "
          + "; ".join(lines_g[:3]) + f"; GCN logits card vs cpu on the "
          f"same parameters max diff {gerr:.2e} (tol 1e-5)")
    return out


def _arg_bytes(*trees) -> int:
    from repro_torch.train.tree import leaves_with_paths, parts
    return sum(p.numel() * p.element_size() for tree in trees
               for _, leaf in leaves_with_paths(tree) for p in parts(leaf))


def _live_at_peak(step, top: int = 6) -> dict:
    """``step()`` under the allocator's history: the bytes its own
    allocations hold at their peak, and the largest of them then, summed
    by where they were made (the first frame in the repo, else the first
    frame); and those still held when it returns."""
    import torch
    torch.cuda.memory._record_memory_history(max_entries=1_000_000,
                                             stacks="python")
    try:
        step()
        torch.cuda.synchronize()
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    events = [e for trace in snap["device_traces"] for e in trace]
    freed = "free_completed" if any(e["action"] == "free_completed"
                                    for e in events) else "free_requested"
    live, now, best, at = {}, 0, 0, {}
    for e in events:
        if e["action"] == "alloc":
            live[e["addr"]] = e
            now += e["size"]
        elif e["action"] == freed and e["addr"] in live:
            now -= live.pop(e["addr"])["size"]
        else:
            continue
        if now > best:
            best, at = now, dict(live)

    def origin(e) -> str:
        frames = e.get("frames") or [{"filename": "?", "line": 0,
                                      "name": "?"}]
        f = next((f for f in frames if "repro_torch" in f["filename"]),
                 frames[0])
        return (f"{f['filename'].split('src/')[-1].split('packages/')[-1]}"
                f":{f['line']} ({f['name']})")

    def largest(blocks) -> list:
        by = {}
        for e in blocks:
            k = origin(e)
            by[k] = by.get(k, 0) + e["size"]
        return sorted(by.items(), key=lambda kv: -kv[1])[:top]

    return dict(peak_bytes=best, blocks=len(at),
                largest=largest(at.values()),
                kept_bytes=sum(e["size"] for e in live.values()),
                kept=largest(live.values()))


def _peak_line(c: dict) -> str:
    """15b's memory reading: the dry run's temp bytes against each step's
    own peak (``max_memory_allocated`` less what the arguments hold), and
    what the allocator's history finds live at the first step's peak."""
    def gb(items) -> str:
        return ", ".join(f"{k} {v / 1e9:.3f} GB" for k, v in items)

    first, counted = (c["first_step_live_at_peak"],
                      c["counted_step_live_at_peak"])
    return (f"predicted temp {c['temp_bytes'] / 1e9:.3f} GB against the "
            f"steps' own peaks (first, under FlopCounterMode, timed) "
            + ", ".join(f"{p / 1e9:.3f}" for p in c["step_peaks"])
            + f" GB (peak {c['peak_bytes'] / 1e9:.3f} against the plain "
            f"steps' {c['measured_peak_bytes'] / 1e9:.3f} GB; arguments "
            f"allocated "
            f"{c['arguments_allocated'] / 1e9:.3f} GB); at the first "
            f"step's peak {first['peak_bytes'] / 1e9:.3f} GB in "
            f"{first['blocks']} blocks, the largest by origin: "
            f"{gb(first['largest'])}; still held after it "
            f"{first['kept_bytes'] / 1e9:.3f} GB: {gb(first['kept'])}; at "
            f"the FlopCounterMode step's peak "
            f"{counted['peak_bytes'] / 1e9:.3f} GB in {counted['blocks']} "
            f"blocks: {gb(counted['largest'])}")


def _calibrate(spec, run, card, reps: int) -> dict:
    """The dry run's counts of ``spec`` against ``run()``, which builds
    the spec's real arguments on ``card`` and returns them with a step on
    them.  Each step's own peak is read from after the arguments exist
    (``max_memory_allocated`` less what they hold): the first step under
    the allocator's history (:func:`_live_at_peak`), one under
    ``FlopCounterMode``, ``reps`` timed with CUDA events.  Gates: FLOPs
    and argument bytes exact."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.hlo_analysis import roofline_from_counts
    t0 = time.perf_counter()
    dry = D.count_spec(spec)
    terms = roofline_from_counts(dry.flops, dry.hbm_bytes, dry.collectives,
                                 1)
    trace_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    args, step = run()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    peaks = []

    def own():
        torch.cuda.reset_peak_memory_stats()
        step()
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() - held)

    live = _live_at_peak(own)
    with FlopCounterMode(display=False) as fc:
        counted = _live_at_peak(own)
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    ms = []
    for _ in range(reps):
        torch.cuda.reset_peak_memory_stats()
        start.record()
        step()
        stop.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(stop))
        peaks.append(torch.cuda.max_memory_allocated() - held)
    real = _arg_bytes(*args)
    flops = fc.get_total_flops()
    if dry.flops != flops or dry.argument_bytes != real:
        raise SystemExit(f"[dryrun] 15b the dry run counts {dry.flops} "
                         f"FLOPs and {dry.argument_bytes} argument bytes; "
                         f"the card's run {flops} and {real}")
    med = sorted(ms)[len(ms) // 2]
    plain = peaks[:1] + peaks[2:]     # not the FlopCounterMode step's
    return dict(flops=flops, argument_bytes=real,
                arguments_allocated=held - base,
                temp_bytes=dry.temp_bytes, step_peaks=peaks,
                measured_temp_bytes=max(plain),
                peak_bytes=dry.temp_bytes + dry.argument_bytes,
                measured_peak_bytes=held - base + max(plain),
                first_step_live_at_peak=live,
                counted_step_live_at_peak=counted, hbm_bytes=dry.hbm_bytes,
                compute_ms=terms.compute_s * 1e3,
                memory_ms=terms.memory_s * 1e3, ms=ms, ms_median=med,
                roofline_share=max(terms.compute_s, terms.memory_s) * 1e3
                / med, trace_s=trace_s)


def _dryrun(seed: int, card, lm: dict | None = None) -> dict:
    """Phase 15: the dry run.  Returns the ``dryrun`` line's object."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed import Mesh, P, shard_tensor
    from repro_torch.distributed.sharding import (lm_param_spec, spec_tree,
                                                  zero1_spec)
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import specs as SP
    from repro_torch.launch import train as launch_train
    from repro_torch.models.transformer import init_params
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.optimizer import OptState, init_opt_state
    from repro_torch.train.tree import Stacked, leaves_with_paths
    out = {}

    # 15a: every cell on both production meshes, on the meta device
    t0 = time.perf_counter()
    recs = [D.run_cell(a, s, mp, verbose=False)
            for mp in (False, True) for a, s in SP.all_cells()]
    bad = [(r["arch"], r["shape"], r["mesh"]) for r in recs
           if r["status"] != "ok"]
    if len(recs) != 86 or bad:
        raise SystemExit(f"[dryrun] 15a {len(recs)} records, not ok: {bad}")
    fams = {}
    for r in recs:
        f = get_arch(r["arch"]).family
        if f not in fams or r["memory"]["peak_bytes"] > \
                fams[f]["memory"]["peak_bytes"]:
            fams[f] = r
    over = [f"{r['arch']} {r['shape']} @ {r['mesh']}" for r in recs
            if r["memory"]["argument_bytes"] > CARD_BYTES]
    out["15a"] = dict(records=len(recs), ok=len(recs) - len(bad),
                      by_family={f: dict(cell=f"{r['arch']} {r['shape']} @ "
                                         f"{r['mesh']}",
                                         peak_bytes=r["memory"]["peak_bytes"],
                                         argument_bytes=r["memory"][
                                             "argument_bytes"],
                                         bottleneck=r["roofline"][
                                             "bottleneck"])
                                 for f, r in sorted(fams.items())},
                      arguments_over_80gb=over,
                      bottlenecks={b: sum(r["roofline"]["bottleneck"] == b
                                          for r in recs) for b in
                                   ("compute", "memory", "collective")},
                      s=time.perf_counter() - t0)
    print(f"[dryrun] 15a {len(recs)} records on (16, 16) and (2, 16, 16) "
          f"meshes of meta entries, all ok, in {out['15a']['s']:.1f} s; "
          f"bottlenecks {out['15a']['bottlenecks']}")
    for f, r in sorted(fams.items()):
        print(f"[dryrun] 15a {f}: largest per-device peak "
              f"{r['memory']['peak_bytes'] / 1e9:.3f} GB ({r['arch']} "
              f"{r['shape']} @ {r['mesh']}, arguments "
              f"{r['memory']['argument_bytes'] / 1e9:.3f} GB), "
              f"{r['roofline']['bottleneck']}-bound")
    print(f"[dryrun] 15a cells whose arguments alone pass "
          f"{CARD_BYTES / 1e9:.0f} GB a device: {over or 'none'}")

    # 15b: the dry run against the card's run of the same spec
    t0 = time.perf_counter()
    mesh = Mesh([[card]], ("data", "model"))
    arch = get_arch("yi-6b")
    spec = SP.lm_train_spec(arch, ShapeSpec("train_4k", "train", {
        "seq": TRAIN_SEQ, "batch": 1}), mesh, n_layers_override=2)
    gen = torch.Generator(card).manual_seed(seed)

    def train_run():
        model = init_params(spec.args[0].cfg, gen, card)
        opt = init_opt_state(model)
        batch = {k: torch.randint(0, model.cfg.vocab, (1, TRAIN_SEQ),
                                  generator=gen, device=card,
                                  dtype=torch.int32)
                 for k in ("tokens", "targets")}
        return (model, opt, batch), lambda: spec.fn(model, opt, batch)

    b = _calibrate(spec, train_run, card, DRY_STEPS)
    out["15b_train"] = b
    print(f"[dryrun] 15b yi-6b train step (2 layers, seq {TRAIN_SEQ}, "
          f"batch 1) on Mesh([[cuda:0]]): FLOPs {b['flops']:,} == the "
          f"card's count, arguments {b['argument_bytes']:,} bytes == the "
          f"real ones; {_peak_line(b)}; "
          f"compute {b['compute_ms']:.2f} ms, memory {b['memory_ms']:.2f} "
          f"ms against a measured step of {b['ms_median']:.2f} ms (median "
          f"of {DRY_STEPS}: {', '.join(f'{x:.2f}' for x in b['ms'])}), "
          f"{100 * b['roofline_share']:.1f}% of its roofline")
    torch.cuda.empty_cache()

    s_cache, lanes = LM_SERVE["s_cache"], LM_SERVE["max_batch"]
    spec = SP.lm_decode_spec(arch, ShapeSpec("decode_32k", "decode", {
        "seq": s_cache, "batch": lanes}), mesh)

    def decode_run():
        model = init_params(spec.args[0].cfg, gen, card)
        cache = model.init_cache(lanes, s_cache)
        token = torch.randint(0, model.cfg.vocab, (lanes,), generator=gen,
                              device=card, dtype=torch.int32)
        # lanes at every depth of the cache, the deepest at its last slot
        step = s_cache // lanes
        pos = (torch.arange(lanes, device=card, dtype=torch.int32) + 1) \
            * step - 1
        return (model, token, cache, pos), \
            lambda: spec.fn(model, token, cache, pos)

    d = _calibrate(spec, decode_run, card, DRY_TICKS)
    bound = (lm or {}).get("12c", {}).get("step_bound_ms")
    d["phase12c_step_bound_ms"] = bound
    out["15b_decode"] = d
    out["15b_s"] = time.perf_counter() - t0
    print(f"[dryrun] 15b yi-6b decode tick (32 layers, {lanes} lanes, "
          f"s_cache {s_cache}): FLOPs {d['flops']:,} == the card's count, "
          f"arguments {d['argument_bytes']:,} bytes == the real ones; "
          f"{_peak_line(d)}; "
          f"compute {d['compute_ms']:.3f} ms, memory {d['memory_ms']:.3f} "
          f"ms against a measured tick of {d['ms_median']:.2f} ms (median "
          f"of {DRY_TICKS}), {100 * d['roofline_share']:.1f}% of its "
          f"roofline; 12c's byte bound "
          + (f"{bound:.3f} ms" if bound else "not measured in this run"))
    torch.cuda.empty_cache()

    # 15c: elastic restore onto meshes of repeated cuda:0, and the
    # production launcher
    t0 = time.perf_counter()
    cfg = arch.smoke_config
    model = init_params(cfg, torch.Generator(card).manual_seed(seed), card)
    opt = init_opt_state(model)
    g = torch.Generator(card).manual_seed(seed + 1)
    for _, leaf in leaves_with_paths((opt.mu, opt.nu)):
        leaf.copy_(torch.randn(leaf.shape, generator=g, device=card))
    state = {"params": model, "opt": opt,
             "step": torch.tensor(7, dtype=torch.int32, device=card)}
    saved = {p: (leaf.stack() if isinstance(leaf, Stacked) else leaf)
             .detach() for p, leaf in leaves_with_paths(state)}

    def rule(p, shp, m):
        return lm_param_spec(p, shp, m, n_experts=cfg.n_experts)

    def moment(p, shp, m):
        return zero1_spec(rule(p, shp, m), shp, m)

    def pairs(t, m):
        if isinstance(t, P):
            return (m, t)
        if isinstance(t, OptState):
            return OptState(*(pairs(v, m) for v in t))
        return {k: pairs(v, m) for k, v in t.items()}

    restored = {}
    with tempfile.TemporaryDirectory(prefix="dryrun_") as tmp:
        cm = CheckpointManager(tmp)
        cm.save(5, state)
        for grid in ((2, 2), (1, 4)):
            m = Mesh(np.full(grid, card, dtype=object), ("data", "model"))
            specs = {"params": spec_tree(model, rule, m),
                     "opt": OptState(spec_tree(model, moment, m),
                                     spec_tree(model, moment, m), P()),
                     "step": P()}
            got, _ = cm.restore(5, state, shardings=pairs(specs, m))
            cut = SP.spec_leaves(specs)
            flat = {}

            def walk(t, prefix=""):
                if isinstance(t, list):
                    flat[prefix] = t
                    return
                items = (zip((f".{f}" for f in t._fields), t)
                         if isinstance(t, OptState) else t.items())
                for k, v in items:
                    walk(v, f"{prefix}/{k}" if prefix else k)

            walk(got)
            n = 0
            for path, shards in flat.items():
                want = shard_tensor(saved[path], cut[path], m)
                if len(shards) != len(want) or not all(
                        a.device == card and torch.equal(a, w)
                        for a, w in zip(shards, want)):
                    raise SystemExit(f"[dryrun] 15c {path} restored onto "
                                     f"{grid} differs from shard_tensor of "
                                     f"the saved tensor")
                n += len(shards)
            restored[f"{grid[0]}x{grid[1]}"] = dict(leaves=len(flat),
                                                    shards=n)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rec = launch_train.main(["--arch", "yi-6b"])
    if rec["status"] != "ok":
        raise SystemExit(f"[dryrun] 15c launch/train.py --arch yi-6b: "
                         f"{rec['status']}")
    out["15c"] = dict(restored=restored, production=dict(
        mesh=rec["mesh"], memory=rec["memory"],
        bottleneck=rec["roofline"]["bottleneck"]),
        s=time.perf_counter() - t0)
    print(f"[dryrun] 15c restore(shardings=) of yi-6b's smoke state onto "
          f"(2, 2) and (1, 4) meshes of cuda:0: "
          + "; ".join(f"{k} {v['leaves']} leaves, {v['shards']} shards"
                      for k, v in restored.items())
          + " — each equal to shard_tensor of the saved tensor bit for "
          f"bit; launch/train.py --arch yi-6b (production mode): "
          f"{rec['status']}, peak {rec['memory']['peak_bytes'] / 1e9:.3f} "
          f"GB a device on {rec['mesh']}, "
          f"{rec['roofline']['bottleneck']}-bound")
    return out


def main() -> int:
    # phase 13c runs under torch.use_deterministic_algorithms, which needs
    # cuBLAS's fixed workspace from the first handle on
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--num-docs", type=int, default=20000)
    ap.add_argument("--vocab", type=int, default=20000)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    from repro_torch import kernels as KR
    from repro_torch.core.ef import ef_next_geq_np
    from repro_torch.index.codec_tier import build_codec_tier
    from repro_torch.kernels.ef_next_geq import ops as K3
    from repro_torch.kernels.list_intersect import ops as K1
    from repro_torch.kernels.page_score import ops as K2
    from repro_torch.kernels.pair_count import ops as K4
    from repro_torch.kernels.pair_count import pair_count_ref
    from repro_torch.launch import quickstart
    from repro_torch.core.repair import repair_compress
    from repro_torch.launch.serve import (boolean_workload, ranked_workload,
                                          zipf_postings)
    from repro_torch.serve import QueryServer

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = _nvidia_smi()
    print(f"[device] {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    logs = KR.build_kernels()
    print(f"[build] {len(logs)} kernel(s) compiled in "
          f"{time.perf_counter() - t0:.2f} s into {KR.BUILD_DIR}")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    # 3. index
    t0 = time.perf_counter()
    lists, term_ids = zipf_postings(args.num_docs, args.vocab, args.seed)
    res = repair_compress(lists)
    t_build = time.perf_counter() - t0
    lengths = [len(l) for l in lists]
    srv = QueryServer(res, engine="cuda", device="cuda",
                      batch_window=CONCURRENCY, codec="repair")
    eng = srv.engine
    si = eng.score_index
    tables1, statics1, host1 = K1.pad_paged_operands(eng.pi)
    tables2, statics2 = K2.pad_score_operands(eng.pi)
    dev_bytes = sum(t.numel() * t.element_size() for t in
                    (*vars(eng.fi).values(), *vars(eng.pi).values(),
                     tables2["clens_pg"]) if isinstance(t, torch.Tensor))
    print(f"[index] {args.num_docs} docs, {len(lists)} lists, "
          f"{sum(lengths)} postings -> {res.grammar.num_rules} rules, "
          f"{res.seq.size} stream symbols, {eng.pi.num_pages} pages of "
          f"{eng.pi.page_size}, {si.pg_page.size} score entries; host "
          f"Re-Pair {t_build:.1f} s; {dev_bytes / 2**20:.1f} MiB on the "
          f"device; max_scan {statics1['max_scan']}, max_depth "
          f"{statics1['max_depth']}")
    tiers = {}
    for mode in TIER_MODES:
        t0 = time.perf_counter()
        tiers[mode] = tier = build_codec_tier(res, mode)
        t_tier = time.perf_counter() - t0
        rep = tier.space_report(res)
        ef = tier.ef
        print(f"[tier] {mode}: lists {rep['counts']}, "
              f"{rep['bits_per_posting']:.2f} bits/posting "
              f"({rep['total_bits'] / 8 / 2**20:.2f} MiB); EF store "
              f"{ef.lo_words.size} low + {ef.hi_words.size} high words, max "
              f"bucket {ef.max_bucket}; tier built in {t_tier:.2f} s")

    # 3b. construct: the same postings built on the card and the host
    con = _construct(lists)
    st, gr = con["stats"], con["res"].grammar
    budget = con["builder"].config.budget * 2 ** st["growths"]
    print(f"[construct] table_cap {BUILD_TABLE_CAP}, 64 pairs per round: "
          f"{gr.num_rules} rules, {con['res'].seq.size} stream symbols, T "
          f"{gr.num_terminals}, T + rule budget {gr.num_terminals + budget}"
          f"; {st['rounds']} rounds, {st['growths']} rule-budget growths, "
          f"{st['compactions']} compactions, {st['fallbacks']} exact "
          f"fallbacks; wall time cuda {con['t_cuda']:.3f} s, torch "
          f"{con['t_torch']:.3f} s, host {con['t_host']:.2f} s; the three "
          f"grammars bit-identical, every list decodes to its postings; "
          f"pair_count launched {con['launches']['pair_count']} times (= "
          f"rounds)")
    prof, k4_path = _profile_path(
        lambda: con["builder"].build_grammar(lists), ["pair_count"])
    _print_profile("construct", f"a second cuda build ({st['rounds']} "
                   f"rounds)", prof)
    _print_path("construct", "the second cuda build", k4_path,
                ["pair_count"])

    # 4. kernels against their plain versions, on the card
    lids, xs = _k1_lanes(lists, res.universe, lengths, args.seed)
    order, *lanes_np = K1.route_pages(host1, lids, xs)
    lanes = [torch.from_numpy(a).cuda() for a in lanes_np]
    out, k1_bool = _hold(
        "list_intersect", K1.paged_intersect, K1.paged_intersect_plain,
        (*lanes, tables1), statics1,
        lambda: k1_traffic(lanes, tables1, statics1))
    oracle = _oracle_next_geq(lists, lids[order], xs[order])
    if not np.array_equal(out.cpu().numpy(), oracle):
        raise SystemExit(f"[kernels] list_intersect disagrees with the "
                         f"oracle in {int((out.cpu().numpy() != oracle).sum())}"
                         f" lanes")
    k1_bool = dict(batch="boolean conjunction probes and edge lanes",
                   size=int(lids.size), **k1_bool)
    _print_hold("list_intersect", k1_bool, "lanes", "plain and oracle")

    bags = ranked_workload(len(lists), lengths, n_queries=RANKED_QUERIES,
                           seed=args.seed)
    ent = []
    for t in sorted({t for bag in bags for t in bag},
                    key=lambda t: -lengths[t]):
        ent.extend(range(int(si.page_off[t]), int(si.page_off[t + 1])))
    ent = np.asarray(ent[:K2_ENTRIES], np.int64)
    pages = si.pg_page[ent].astype(np.int64)
    meta_np = (pages, si.pg_sym_lo[ent] - pages * si.page_size,
               si.pg_sym_hi[ent] - si.pg_sym_lo[ent], si.pg_base[ent],
               si.pg_head[ent], si.pg_count[ent])
    meta = [torch.from_numpy(np.ascontiguousarray(a, np.int32)).cuda()
            for a in meta_np]
    kw2 = dict(b_pad=eng.page_elem_bucket(), **statics2)
    out, k2_dir = _hold(
        "page_score", K2.page_score, K2.page_score_plain, (*meta, tables2),
        kw2, lambda: k2_traffic(meta, tables2, kw2, kw2["b_pad"]))
    rows = out.cpu().numpy()
    for q, e in enumerate(ent.tolist()):
        lo, c = int(si.pg_elem_lo[e]), int(si.pg_count[e])
        want = lists[int(si.pg_list[e])][lo:lo + c]
        if not (np.array_equal(rows[q, :c], want)
                and (rows[q, c:] == 2**31 - 1).all()):
            raise SystemExit(f"[kernels] page_score row of entry {e} "
                             f"differs from its list")
    k2_dir = dict(batch=f"directory entries of the ranked bags' terms, "
                  f"{kw2['b_pad']} slots", size=int(ent.size), **k2_dir)
    _print_hold("page_score", k2_dir, "entries", "plain and lists")

    ef_store = tiers["ef"].ef
    rank = ef_store.select_samples()
    pack3 = K3.pad_ef_operands(ef_store, rank, "cuda")
    lids3, xs3 = _k3_lanes(lids, xs, lists, res.universe, lengths)
    lanes3 = tuple(torch.from_numpy(a).cuda() for a in (lids3, xs3))
    out, k3_bool = _hold("ef_next_geq", K3.ef_next_geq, K3.ef_next_geq_plain,
                         (*lanes3, pack3), {},
                         lambda: k3_traffic(*lanes3, pack3))
    got = out.cpu().numpy()
    for what, want in (("numpy reference",
                        ef_next_geq_np(ef_store, rank, lids3, xs3)),
                       ("oracle", _oracle_next_geq(lists, lids3, xs3))):
        if not np.array_equal(got, want):
            raise SystemExit(f"[kernels] ef_next_geq disagrees with the "
                             f"{what} in {int((got != want).sum())} lanes")
    k3_bool = dict(batch="boolean conjunction probes and EF edge lanes, "
                   "'ef' tier", size=int(lids3.size), **k3_bool)
    _print_hold("ef_next_geq", k3_bool, "lanes",
                "plain, numpy reference and oracle")

    r1 = con["round1"]
    ca, cb, pa, pb, vm = r1
    out, k4_r1 = _hold("pair_count", K4.pair_count, K4.pair_count_plain, r1,
                       {}, lambda: k4_traffic(ca, pa, vm))
    got = out.cpu().numpy()
    if not np.array_equal(got, _pair_count_np(*(t.cpu().numpy()
                                                 for t in r1))):
        raise SystemExit("[kernels] pair_count disagrees with the numpy "
                         "counts on round 1")
    if not torch.equal(_unique_counts(*r1), out):
        raise SystemExit("[kernels] the unique-count yardstick disagrees "
                         "with pair_count")
    k4_r1 = dict(batch=f"round 1 of the cuda build, {int(ca.numel())} "
                 f"candidates ({int((ca >= 0).sum())} live)",
                 size=int(pa.numel()),
                 library_ms=_device_ms(lambda: _unique_counts(*r1), 100)[0],
                 **k4_r1)
    _print_hold("pair_count", k4_r1, "pair slots", "plain and numpy")
    seq, active, ca_e, cb_e = _k4_edge(np.random.default_rng(args.seed))
    stream = K4.pair_stream(torch.from_numpy(seq).cuda(),
                            torch.from_numpy(active).cuda(), seq.size)
    cand = [torch.from_numpy(a).cuda() for a in (ca_e, cb_e)]
    out, k4_edge = _hold("pair_count", K4.pair_count, K4.pair_count_plain,
                         (*cand, *stream), {},
                         lambda: k4_traffic(cand[0], stream[0], stream[2]))
    got = out.cpu().numpy()
    if not (np.array_equal(got, pair_count_ref(seq, active, seq.size, ca_e,
                                               cb_e))
            and np.array_equal(got[400:600], got[:200])
            and not got[100:310].any() and not got[600:650].any()):
        raise SystemExit("[kernels] pair_count's edge batch disagrees with "
                         "pair_count_ref")
    none = torch.zeros_like(stream[2])
    one = [torch.tensor(v, dtype=torch.int32).cuda()
           for v in ([3, 4, 3], [4, 3, 4], [3], [4], [1])]
    if K4.pair_count(*cand, stream[0], stream[1], none).any() \
            or K4.pair_count(*one).tolist() != [1, 0, 1]:
        raise SystemExit("[kernels] pair_count miscounts an all-invalid or "
                         "a one-slot stream")
    k4_edge = dict(batch="edge batch: 1,037 candidates with sentinels and "
                   "duplicates, invalid and -1 slots", size=int(seq.size),
                   **k4_edge)
    _print_hold("pair_count", k4_edge, "pair slots",
                "plain and pair_count_ref (and all-invalid / one-slot "
                "streams exact)")

    # 5. serve, once per codec; launch counts zeroed just before each run
    queries = boolean_workload(len(lists), lengths,
                               n_queries=BOOLEAN_QUERIES, seed=args.seed)
    wrappers = {(K1, "paged_intersect"): "list_intersect",
                (K2, "page_score"): "page_score",
                (K3, "ef_next_geq"): "ef_next_geq"}
    runs = {"repair": (srv, _serve(srv, queries, bags, lists, res.universe,
                                   wrappers))}
    run = runs["repair"][1]
    launches, st = run["launches"], run["stats"]
    lat_b, lat_r = run["lat_bool"], run["lat_rank"]
    print(f"[serve] boolean: {len(queries)} queries at concurrency "
          f"{CONCURRENCY} in {run['t_bool']:.3f} s "
          f"({len(queries) / run['t_bool']:.1f} q/s), p50 "
          f"{np.percentile(lat_b, 50):.2f} ms, p95 "
          f"{np.percentile(lat_b, 95):.2f} ms; all answers equal "
          f"naive_eval")
    print(f"[serve] ranked top-{TOPK}: {len(bags)} queries in "
          f"{run['t_rank']:.3f} s ({len(bags) / run['t_rank']:.1f} q/s), p50 "
          f"{np.percentile(lat_r, 50):.2f} ms, p95 "
          f"{np.percentile(lat_r, 95):.2f} ms, pages scored "
          f"{st['pages_scored']} / skipped {st['pages_skipped']}; all "
          f"answers equal rank_oracle (exact scores and order)")
    print(f"[serve] launches {launches}, dispatches {st['dispatches']}, "
          f"lanes {st['real_lanes']} real / {st['unique_lanes']} unique / "
          f"{st['pad_lanes']} pad; launch shapes (lanes / entries) "
          f"{run['shapes']}")
    if launches["list_intersect"] == 0 or launches["page_score"] == 0:
        raise SystemExit(f"[serve] a kernel never launched: {launches}")
    for mode in TIER_MODES:
        tsrv = QueryServer(res, engine="cuda", device="cuda",
                           batch_window=CONCURRENCY, codec=tiers[mode])
        runs[mode] = (tsrv, _serve(tsrv, queries, bags, lists,
                                   res.universe, wrappers))
    print("[serve] per codec (same 256 boolean + 64 ranked queries, every "
          "answer equal naive_eval / rank_oracle):")
    for mode, (_, run) in runs.items():
        st = run["stats"]
        print(f"[serve]   {mode}: boolean "
              f"{len(queries) / run['t_bool']:.1f} q/s, p50 "
              f"{np.percentile(run['lat_bool'], 50):.2f} / p95 "
              f"{np.percentile(run['lat_bool'], 95):.2f} ms; ranked "
              f"{len(bags) / run['t_rank']:.1f} q/s, p50 "
              f"{np.percentile(run['lat_rank'], 50):.2f} / p95 "
              f"{np.percentile(run['lat_rank'], 95):.2f} ms; codec "
              f"dispatches {st['codec_dispatches']}; launches "
              f"{run['launches']}; K3 launch shapes "
              f"{run['shapes']['ef_next_geq']}")
    if runs["ef"][1]["launches"]["ef_next_geq"] == 0:
        raise SystemExit("[serve] ef_next_geq never launched while serving "
                         "under codec 'ef'")

    # 5b. each kernel's largest serve launch, held against its plain
    # version on the same inputs and timed (after the counts were read),
    # beside the searchsorted yardstick for K1 and K3
    lib = _SortedPostings(lists, res.universe)
    n, ph, a, kw = runs["repair"][1]["largest"]["list_intersect"]
    out, k1_srv = _hold("list_intersect", K1.paged_intersect,
                        K1.paged_intersect_plain, a, kw,
                        lambda: k1_traffic(a[:4], a[4], kw))
    oracle = _oracle_next_geq(lists, a[0].cpu().numpy(), a[1].cpu().numpy())
    if not np.array_equal(out.cpu().numpy(), oracle):
        raise SystemExit("[kernels] list_intersect disagrees with the "
                         "oracle on the largest serve launch")
    k1_srv = dict(batch=f"largest serve launch ({ph} queries)", size=n,
                  library_ms=_library(lib, a[0], a[1], out), **k1_srv)
    _print_hold("list_intersect", k1_srv, "lanes", "plain and oracle")
    k2_srv = []
    for i, (n, ph, a, kw) in enumerate(sorted(
            runs["repair"][1]["k2_calls"], key=lambda c: -c[0])):
        _, row = _hold("page_score", K2.page_score, K2.page_score_plain, a,
                       kw, lambda: k2_traffic(a[:6], a[6], kw, kw["b_pad"]))
        row = dict(batch=f"{'largest ' if i == 0 else ''}serve launch "
                   f"({ph} queries), {kw['b_pad']} slots", size=n, **row)
        _print_hold("page_score", row, "entries", "plain")
        k2_srv.append(row)
    mode, (n, ph, a, kw) = max(
        ((m, runs[m][1]["largest"]["ef_next_geq"]) for m in TIER_MODES
         if "ef_next_geq" in runs[m][1]["largest"]), key=lambda r: r[1][0])
    out, k3_srv = _hold("ef_next_geq", K3.ef_next_geq, K3.ef_next_geq_plain,
                        a, kw, lambda: k3_traffic(*a))
    got = out.cpu().numpy()
    lid_np, x_np = a[0].cpu().numpy(), a[1].cpu().numpy()
    store = tiers[mode].ef
    for what, want in (("numpy reference", ef_next_geq_np(
            store, store.select_samples(), lid_np, x_np)),
            ("oracle", _oracle_next_geq(lists, lid_np, x_np))):
        if not np.array_equal(got, want):
            raise SystemExit(f"[kernels] ef_next_geq disagrees with the "
                             f"{what} on the largest serve launch")
    k3_srv = dict(batch=f"largest serve launch ({ph} queries, codec "
                  f"{mode!r})", size=n,
                  library_ms=_library(lib, a[0], a[1], out), **k3_srv)
    _print_hold("ef_next_geq", k3_srv, "lanes",
                "plain, numpy reference and oracle")
    print(f"[kernels] ef_next_geq's largest launch, lane layout: "
          f"{json.dumps(k3_layout(*a))}")
    print(f"[kernels] searchsorted yardstick over the uncompressed postings: "
          f"list_intersect's launch {k1_srv['library_ms']:.5f} ms, "
          f"ef_next_geq's launch {k3_srv['library_ms']:.5f} ms")

    # 6. profile: the serve passes of phase 5 again, on fresh servers (no
    # memo, no result cache) under torch.profiler — each kernel's device
    # time summed over its launches on the path ('repair': K1, K2; 'ef': K3)
    def fresh_pass(codec):
        def run():
            fresh = QueryServer(res, engine="cuda", device="cuda",
                                batch_window=CONCURRENCY, codec=codec)
            fresh.search_many(queries)
            fresh.search_topk_many(bags, TOPK)
        return run

    _, serve_path = _profile_path(fresh_pass("repair"),
                                  ["list_intersect", "page_score"])
    _print_path("profile", f"the 'repair' serve pass (phase 5 launched "
                f"{launches['list_intersect']} and {launches['page_score']})",
                serve_path, ["list_intersect", "page_score"])
    k3_launches = {"ef_next_geq": runs["ef"][1]["launches"]["ef_next_geq"]}
    _, ef_path = _profile_path(fresh_pass(tiers["ef"]), ["ef_next_geq"])
    _print_path("profile", f"the 'ef' serve pass (phase 5 launched "
                f"{k3_launches['ef_next_geq']})", ef_path, ["ef_next_geq"])
    report = [
        _kernel_row("list_intersect", "src/repro_torch/csrc/list_intersect.cu",
                    "src/repro/kernels/list_intersect/list_intersect.py:158",
                    launches, serve_path, k1_srv, k1_bool),
        _kernel_row("page_score", "src/repro_torch/csrc/page_score.cu",
                    "src/repro/kernels/page_score/page_score.py:122",
                    launches, serve_path, *k2_srv, k2_dir),
        _kernel_row("ef_next_geq", "src/repro_torch/csrc/ef_next_geq.cu",
                    "src/repro/kernels/ef_next_geq/ef_next_geq.py:131",
                    k3_launches, ef_path, k3_srv, k3_bool),
        _kernel_row("pair_count", "src/repro_torch/csrc/pair_count.cu",
                    "src/repro/kernels/pair_count/pair_count.py:50",
                    con["launches"], k4_path, k4_r1, k4_edge)]
    print("[kernels] " + "; ".join(
        f"{r['name']}: {r['launches']} launches on its path, 0 mismatches, "
        f"{r['ms']:.5f} ms at its main launch" for r in report)
        + f" (ef_next_geq launches counted under codec 'ef'; under "
        f"'adaptive' {runs['adaptive'][1]['launches']['ef_next_geq']}; "
        f"pair_count's in the cuda build)")

    q_prof = boolean_workload(len(lists), lengths,
                              n_queries=BOOLEAN_QUERIES // 4,
                              seed=args.seed + 1)
    b_prof = ranked_workload(len(lists), lengths,
                             n_queries=RANKED_QUERIES // 4, seed=args.seed + 1)
    _print_profile("profile", f"second serve pass ({BOOLEAN_QUERIES // 4} "
                   f"boolean + {RANKED_QUERIES // 4} ranked queries)",
                   _profile(lambda: (srv.search_many(q_prof),
                                     srv.search_topk_many(b_prof, TOPK))))

    # 7. rebuild the running repair server with the cuda builder, serve
    version = srv.version
    KR.reset_launches()
    t0 = time.perf_counter()
    res2 = srv.rebuild(lists, builder=con["builder"])
    torch.cuda.synchronize()
    t_rebuild = time.perf_counter() - t0
    k4_rebuild = KR.LAUNCHES["pair_count"]
    if srv.version != version + 1 or not _same_grammar(res2, con["res"]) \
            or k4_rebuild != con["stats"]["rounds"]:
        raise SystemExit(f"[rebuild] version {version} -> {srv.version}, "
                         f"{k4_rebuild} pair_count launches: the rebuild "
                         f"did not build and swap the construct grammar")
    run = _serve(srv, queries, bags, lists, res2.universe, wrappers)
    if run["launches"]["list_intersect"] == 0 \
            or run["launches"]["page_score"] == 0:
        raise SystemExit(f"[rebuild] a kernel never launched while serving "
                         f"the rebuilt index: {run['launches']}")
    print(f"[rebuild] srv.rebuild(lists, builder=CudaBuilder) in "
          f"{t_rebuild:.3f} s ({k4_rebuild} pair_count launches), index "
          f"version {version} -> {srv.version}, "
          f"{res2.grammar.num_rules} rules; then {len(queries)} boolean "
          f"queries at {len(queries) / run['t_bool']:.1f} q/s and "
          f"{len(bags)} ranked at {len(bags) / run['t_rank']:.1f} q/s, "
          f"launches {run['launches']}; all answers equal naive_eval / "
          f"rank_oracle")

    # 8. aux: K5-K8 through their entry points, then the quickstart flow
    aux = _aux(lists, res, eng.fi, queries, args.seed)
    print("[aux] library yardsticks at the main launches: " + "; ".join(
        f"{name} {rows[0]['library_ms']:.5f} ms" for name, rows in
        aux["rows"].items() if rows[0].get("library_ms") is not None))
    sources = {"grammar_expand": "grammar_expand.py:70",
               "gap_decode": "gap_decode.py:39",
               "bucket_intersect": "bucket_intersect.py:34",
               "bitmap_and": "bitmap_and.py:36"}
    for name, rows in aux["rows"].items():
        report.append(_kernel_row(
            name, f"src/repro_torch/csrc/{name}.cu",
            f"src/repro/kernels/{name}/{sources[name]}", aux["launches"],
            aux["path"], *rows))
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        quickstart.main(device="cuda")
    out = buf.getvalue().splitlines()
    if out[-1] != "quickstart OK":
        raise SystemExit("[aux] the quickstart flow did not finish")
    print(f"[aux] repro_torch.launch.quickstart on the card in "
          f"{time.perf_counter() - t0:.2f} s: " + "; ".join(
              line for line in out if line.startswith(
                  ("torch builder", "12 bigram", "  lookup"))))

    # 9. out-of-core: the phase-3 index from an mmap store at ~10% resident
    ooc = _outofcore(res, lists, queries, bags, runs["repair"][1],
                     eng.pi.num_pages, tables1, host1, statics1, wrappers,
                     lib)
    report[0]["shapes"].extend(ooc["rows"])
    report[0]["max_abs_err"] = max(r["max_abs_err"]
                                   for r in report[0]["shapes"])

    # 10. ingest: documents streamed into the phase-3 index on the card
    ing = _ingest(res, lists, term_ids, args.vocab, args.seed)
    tel = ing["telemetry"]
    print(f"[ingest] {ing['docs']} documents ({ing['postings']} postings) "
          f"into the {len(lists)}-list index in {INGEST_ROUNDS} rounds: "
          f"{ing['docs'] / ing['t_insert']:.1f} inserts/s (flushes "
          f"included); {tel['flushes']} flushes in {tel['flush_ms']:.1f} "
          f"ms, {tel['compactions']} compactions in "
          f"{ing['compact_ms']:.1f} ms (cuda builder, table_cap "
          f"{BUILD_TABLE_CAP}); {tel['segments']} segments at the end "
          f"(base, docs, generation: {ing['layout']}); every answer of "
          f"every round equal naive_eval / rank_oracle over the current "
          f"corpus; launches in the phase {ing['launches']}")
    for r, row in enumerate(ing["rounds"]):
        print(f"[ingest]   round {r}: {row['docs']} docs, "
              f"{row['segments']} segments, {row['flushes']} flushes, "
              f"{row['compactions']} compactions; boolean "
              f"{row['bool_qps']:.1f} q/s, p50 {row['bool_p50']:.2f} / p95 "
              f"{row['bool_p95']:.2f} ms; ranked {row['rank_qps']:.1f} q/s, "
              f"p50 {row['rank_p50']:.2f} / p95 {row['rank_p95']:.2f} ms")

    # 11. mesh: list-sharded serving of the phase-3 index on the card
    t0 = time.perf_counter()
    _mesh(res, lists, queries, bags, runs, tiers, wrappers, args.seed)
    from repro_torch.distributed import Mesh
    ing = _ingest(res, lists, term_ids, args.vocab, args.seed,
                  n_rounds=MESH_INGEST_ROUNDS,
                  mesh=Mesh([torch.device("cuda", 0)]))
    tel = ing["telemetry"]
    print(f"[mesh] 11c phase 10's stream under Mesh([cuda:0]), cut to "
          f"{MESH_INGEST_ROUNDS} rounds: {ing['docs']} documents "
          f"({ing['postings']} postings) at "
          f"{ing['docs'] / ing['t_insert']:.1f} inserts/s; "
          f"{tel['flushes']} flushes, {tel['compactions']} compactions, "
          f"{tel['segments']} segments, every segment engine sharded; "
          f"sharded dispatches {ing['dispatches']}, launches "
          f"{ing['launches']}; every answer of every round equal "
          f"naive_eval / rank_oracle")
    for r, row in enumerate(ing["rounds"]):
        print(f"[mesh]   11c round {r}: boolean {row['bool_qps']:.1f} q/s, "
              f"p50 {row['bool_p50']:.2f} / p95 {row['bool_p95']:.2f} ms; "
              f"ranked {row['rank_qps']:.1f} q/s")
    print(f"[mesh] phase 11 in {time.perf_counter() - t0:.1f} s")

    # 12. lm: the LM serving tier, yi-6b at full width and depth
    t0 = time.perf_counter()
    lm = _lm(args.seed, torch.device("cuda", 0))
    lm["s"] = time.perf_counter() - t0
    print(f"[lm] phase 12 in {lm['s']:.1f} s")
    print(json.dumps({"lm": lm}))

    # 13. train: the training tier, yi-6b at full width
    t0 = time.perf_counter()
    train = _train(args.seed, torch.device("cuda", 0))
    train["s"] = time.perf_counter() - t0
    print(f"[train] phase 13 in {train['s']:.1f} s")
    print(json.dumps({"train": train}))

    # 14. distribution: the model rules of distribution over meshes of
    # repeated cuda:0 entries (no kernel of the port runs here)
    t0 = time.perf_counter()
    dist = _dist(args.seed, torch.device("cuda", 0))
    dist["s"] = time.perf_counter() - t0
    print(f"[dist] phase 14 in {dist['s']:.1f} s")
    print(json.dumps({"distribution": dist}))

    # 15. dryrun: every cell's step traced on the meta device, then held
    # against the card's own run of the same spec
    t0 = time.perf_counter()
    dry = _dryrun(args.seed, torch.device("cuda", 0), lm)
    dry["s"] = time.perf_counter() - t0
    print(f"[dryrun] phase 15 in {dry['s']:.1f} s")
    print(json.dumps({"dryrun": dry}))

    print(json.dumps({"kernels": report}))
    print(_nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
