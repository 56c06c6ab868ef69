#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--seed 0] [--num-docs 20000]

Needs one NVIDIA card.  Phases, each printing its own lines; any failure
exits non-zero:

1. device  — the card's name, and its name and power limit from
   ``nvidia-smi``;
2. build   — both CUDA kernels compiled by ``nvcc`` into ``build_torch/``
   (one process per source, started together), with ptxas reports;
3. index   — a Zipf collection (``zipf_corpus``: 20,000 docs, vocabulary
   20,000, mean length 120) compressed by the host Re-Pair and served by
   ``QueryServer(engine="cuda")``: paged index, probe and page-score
   operand packs and the block-max score directory on the card;
4. kernels — one routed K1 (``list_intersect``) batch of 8,192 lanes
   from the Zipf boolean workload's conjunctions plus edge lanes, and one
   K2 (``page_score``) batch of real score-directory entries, each run by
   its kernel and its plain PyTorch version on the card: outputs must be
   exactly equal (and equal a numpy oracle); both timed with CUDA events
   and ``torch.profiler``;
5. serve   — 256 Zipf boolean queries at concurrency 64 (``search_many``)
   and 64 ranked top-10 queries (``search_topk_many``) through the
   server; launch counts are zeroed just before and read just after, and
   every answer is checked against ``naive_eval`` / ``rank_oracle``.
   Then (5b) each kernel's largest launch of the serve phase — for K1
   the ranked membership round, about two million lanes — is held
   against its plain version on the same inputs and timed the same way;
6. profile — a second, smaller serve pass under ``torch.profiler``: the
   device's busy and idle share and where its time went.

The last lines are the ``kernels`` JSON line (per kernel: launches while
serving, and times and bounds at its largest serve launch, with every
batch it was held on under ``shapes``), the ``nvidia-smi`` line, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
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
K1_LANES, K2_ENTRIES = 8192, 512


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
    host's launch overhead.  Both in ms, after two warm-up calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
    dev_us = sum(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
                 for e in prof.key_averages())
    if dev_us <= 0:
        raise SystemExit("torch.profiler recorded no device time")
    return dev_us / reps / 1e3, start.elapsed_time(stop) / reps


def _serve_profile(srv, queries, bags) -> dict:
    """A second serve pass (fresh queries, warm engine) under
    ``torch.profiler`` and ``cProfile`` at once: its wall ms, the
    device-busy ms (every kernel and copy, summed), the five largest
    device-time entries, and the eight host functions with the most self
    time (both profilers slow the host, so read these as shares)."""
    import cProfile
    import pstats
    import torch
    from torch.profiler import ProfilerActivity, profile
    host = cProfile.Profile()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        host.enable()
        srv.search_many(queries)
        srv.search_topk_many(bags, TOPK)
        torch.cuda.synchronize()
        host.disable()
    wall = (time.perf_counter() - t0) * 1e3
    dev = [(e.key, getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0.0)) / 1e3)
           for e in prof.key_averages()]
    dev = sorted((d for d in dev if d[1] > 0), key=lambda d: -d[1])
    stats = pstats.Stats(host).stats
    top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:8]
    return dict(wall=wall, busy=sum(ms for _, ms in dev), device=dev[:5],
                host=[(f"{Path(f).name}:{line}({fn})", tt * 1e3)
                      for (f, line, fn), (_, _, tt, _, _) in top])


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


def k1_traffic(lanes, tables, statics) -> tuple[float, float]:
    """Bytes and int32 operations one K1 launch needs on these lanes: each
    input read once (lane arrays, per-list span ends and lasts, the union
    of stream positions the skip loops read, the halting symbols, the
    grammar nodes the descents visit), the output written once."""
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
    scanned = int((diff.cumsum(0)[:n] > 0).sum())
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
    p = np.searchsorted(keys, lid * base + np.asarray(xs, np.int64))
    return np.where(p < ends[lid], flat[np.minimum(p, flat.size - 1)],
                    2**31 - 1)


def _hold(name, kernel, plain, args, kw, traffic) -> tuple:
    """Run ``kernel`` and its plain version on the same card tensors; the
    outputs must be equal.  Returns the kernel's output and its numbers:
    device ms of both (kernel over 100 calls, plain over 3), per-call ms,
    and the bound from ``traffic()`` = (bytes, operations)."""
    import torch
    out_k = kernel(*args, **kw)
    out_p = plain(*args, **kw)
    torch.cuda.synchronize()
    bad = int((out_k != out_p).sum())
    if bad:
        raise SystemExit(f"[kernels] {name} disagrees with its plain "
                         f"version in {bad} slots")
    err = int((out_k.long() - out_p.long()).abs().max()) \
        if out_k.numel() else 0
    ms, wall = _device_ms(lambda: kernel(*args, **kw), 100)
    plain_ms, plain_wall = _device_ms(lambda: plain(*args, **kw), 3)
    bound, by = _bound(*traffic())
    return out_k, dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=bound, bound_by=by, call_ms=wall,
                       plain_call_ms=plain_wall)


def _print_hold(name: str, row: dict, unit: str, against: str) -> None:
    print(f"[kernels] {name}, {row['batch']}: {row['size']} {unit}, 0 "
          f"mismatches vs {against}; device {row['ms']:.5f} ms (plain "
          f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.6f} ms by "
          f"{row['bound_by']}); per call {row['call_ms']:.4f} ms (plain "
          f"{row['plain_call_ms']:.3f} ms)")


def _kernel_row(name, source, replaces, launches, serve, other) -> dict:
    """One entry of the ``kernels`` line: the top-level numbers are those
    of the kernel's largest serve launch, where its time counts; every
    batch it was held on is under ``shapes``."""
    return dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=launches[name],
        max_abs_err=max(serve["max_abs_err"], other["max_abs_err"]),
        ms=serve["ms"], plain_ms=serve["plain_ms"],
        bound_ms=serve["bound_ms"], bound_by=serve["bound_by"],
        library_ms=None, shapes=[serve, other])


def main() -> int:
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
    from repro_torch.kernels.list_intersect import ops as K1
    from repro_torch.kernels.page_score import ops as K2
    from repro_torch.launch.serve import (boolean_workload, build_corpus,
                                          ranked_workload)
    from repro_torch.query import naive_eval, rank_oracle
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
    lists, res = build_corpus(args.num_docs, args.vocab, args.seed)
    t_build = time.perf_counter() - t0
    lengths = [len(l) for l in lists]
    srv = QueryServer(res, engine="cuda", device="cuda",
                      batch_window=CONCURRENCY)
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

    # 4. kernels against their plain versions, on the card
    lids, xs = _k1_lanes(lists, res.universe, lengths, args.seed)
    order, *lanes_np = K1.route_pages(host1, lids, xs)
    lanes = [torch.from_numpy(a).cuda() for a in lanes_np]
    out, k1_bool = _hold(
        "list_intersect", K1.list_intersect, K1.list_intersect_plain,
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

    # 5. serve
    queries = boolean_workload(len(lists), lengths,
                               n_queries=BOOLEAN_QUERIES, seed=args.seed)
    # record each launch's batch size (lanes / entries) on the way in, and
    # keep the inputs of each kernel's largest launch for step 5b
    wrappers = {(K1, "list_intersect"): K1.list_intersect,
                (K2, "page_score"): K2.page_score}
    shapes = {name: [] for _, name in wrappers}
    largest: dict[str, tuple] = {}
    phase = ["boolean"]

    def recording(name, fn):
        def call(*a, **kw):
            n = int(a[0].shape[0])
            shapes[name].append(n)
            if n > largest.get(name, (0,))[0]:
                largest[name] = (n, phase[0], a, kw)
            return fn(*a, **kw)
        return call

    for (mod, name), fn in wrappers.items():
        setattr(mod, name, recording(name, fn))
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
    for (mod, name), fn in wrappers.items():
        setattr(mod, name, fn)
    lat = np.asarray(srv.scheduler.latencies, np.float64) * 1e3
    for q, got in zip(queries, outs):
        want = naive_eval(q, lists, res.universe)
        if not np.array_equal(got, want):
            raise SystemExit(f"[serve] boolean answer differs: {q}")
    for bag, got in zip(bags, ranked):
        docs, scores = rank_oracle(lists, res.universe, bag, TOPK)
        if not (np.array_equal(got.docs, docs)
                and np.array_equal(got.scores, scores)):
            raise SystemExit(f"[serve] ranked answer differs: {bag}")
    st = srv.serve_stats()
    print(f"[serve] boolean: {len(queries)} queries at concurrency "
          f"{CONCURRENCY} in {t_bool:.3f} s ({len(queries) / t_bool:.1f} "
          f"q/s), p50 {np.percentile(lat[:n_lat], 50):.2f} ms, p95 "
          f"{np.percentile(lat[:n_lat], 95):.2f} ms; all answers equal "
          f"naive_eval")
    print(f"[serve] ranked top-{TOPK}: {len(bags)} queries in "
          f"{t_rank:.3f} s ({len(bags) / t_rank:.1f} q/s), p50 "
          f"{np.percentile(lat[n_lat:], 50):.2f} ms, p95 "
          f"{np.percentile(lat[n_lat:], 95):.2f} ms, pages scored "
          f"{st['pages_scored']} / skipped {st['pages_skipped']}; all "
          f"answers equal rank_oracle (exact scores and order)")
    print(f"[serve] launches {launches}, dispatches {st['dispatches']}, "
          f"lanes {st['real_lanes']} real / {st['unique_lanes']} unique / "
          f"{st['pad_lanes']} pad; launch shapes (lanes / entries) "
          f"{shapes}")
    if min(launches.values()) == 0:
        raise SystemExit(f"[serve] a kernel never launched: {launches}")

    # 5b. each kernel's largest serve launch, held against its plain
    # version on the same inputs and timed (after the counts were read)
    n, ph, a, kw = largest["list_intersect"]
    out, k1_srv = _hold("list_intersect", K1.list_intersect,
                        K1.list_intersect_plain, a, kw,
                        lambda: k1_traffic(a[:4], a[4], kw))
    oracle = _oracle_next_geq(lists, a[0].cpu().numpy(), a[1].cpu().numpy())
    if not np.array_equal(out.cpu().numpy(), oracle):
        raise SystemExit("[kernels] list_intersect disagrees with the "
                         "oracle on the largest serve launch")
    k1_srv = dict(batch=f"largest serve launch ({ph} queries)", size=n,
                  **k1_srv)
    _print_hold("list_intersect", k1_srv, "lanes", "plain and oracle")
    n, ph, a, kw = largest["page_score"]
    _, k2_srv = _hold("page_score", K2.page_score, K2.page_score_plain, a,
                      kw, lambda: k2_traffic(a[:6], a[6], kw, kw["b_pad"]))
    k2_srv = dict(batch=f"largest serve launch ({ph} queries), "
                  f"{kw['b_pad']} slots", size=n, **k2_srv)
    _print_hold("page_score", k2_srv, "entries", "plain")

    report = [
        _kernel_row("list_intersect", "src/repro_torch/csrc/list_intersect.cu",
                    "src/repro/kernels/list_intersect/list_intersect.py:158",
                    launches, k1_srv, k1_bool),
        _kernel_row("page_score", "src/repro_torch/csrc/page_score.cu",
                    "src/repro/kernels/page_score/page_score.py:122",
                    launches, k2_srv, k2_dir)]
    print("[kernels] " + "; ".join(
        f"{r['name']}: {r['launches']} launches while serving, 0 mismatches, "
        f"{r['ms']:.5f} ms at the largest serve launch" for r in report))

    prof = _serve_profile(
        srv, boolean_workload(len(lists), lengths, n_queries=BOOLEAN_QUERIES
                              // 4, seed=args.seed + 1),
        ranked_workload(len(lists), lengths, n_queries=RANKED_QUERIES // 4,
                        seed=args.seed + 1))
    busy = 100 * prof["busy"] / prof["wall"]
    print(f"[profile] second serve pass ({BOOLEAN_QUERIES // 4} boolean + "
          f"{RANKED_QUERIES // 4} ranked queries, profilers on): wall "
          f"{prof['wall']:.1f} ms, device busy {prof['busy']:.1f} ms "
          f"({busy:.2f}%), idle {100 - busy:.2f}%")
    print("[profile] device: " + "; ".join(
        f"{k[:70]} {ms:.2f} ms" for k, ms in prof["device"]))
    print("[profile] host self time: " + "; ".join(
        f"{k} {ms:.0f} ms" for k, ms in prof["host"]))

    print(json.dumps({"kernels": report}))
    print(_nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
