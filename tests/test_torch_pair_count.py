"""Kernel K4 (``pair_count``) of the port against the JAX package (CPU).

The port's plain version and its wrapper on CPU tensors (which runs the
plain version) are held EXACTLY equal to ``repro.kernels.pair_count``'s
Pallas kernel, run by the interpreter, and to the numpy oracle
``pair_count_ref``: random streams, ``-1`` sentinels and duplicate
candidates, candidate tables that are not a tile multiple, empty and
all-invalid streams, and the real candidate table and pair stream of a
cuda-builder round.
"""

import numpy as np
import pytest
import torch

from repro.kernels.pair_count import pair_count as pair_count_jax
from repro.kernels.pair_count import pair_count_pallas
from repro.kernels.pair_count.ops import _pair_stream as pair_stream_jax
from repro.kernels.pair_count.ref import pair_count_ref as ref_jax

from repro_torch.kernels.pair_count import (pair_count, pair_count_plain,
                                            pair_count_ref, pair_keys,
                                            pair_stream)

T = torch.from_numpy


def _stream(rng, n, Np, alphabet, p_active=0.85):
    seq = np.zeros(Np, np.int32)
    seq[:n] = rng.integers(0, alphabet, n)
    active = np.zeros(Np, bool)
    active[:n] = rng.random(n) < p_active
    return seq, active


def _cands(rng, K, used, alphabet):
    ca = np.full(K, -1, np.int32)
    cb = np.full(K, -1, np.int32)
    ca[:used] = rng.integers(0, alphabet, used)
    cb[:used] = rng.integers(0, alphabet, used)
    return ca, cb


def _port(seq, active, n, ca, cb):
    """The port's wrapper and plain version on the same CPU tensors."""
    pa, pb, vm = pair_stream(T(seq), T(active), n)
    got = pair_count(T(ca), T(cb), pa, pb, vm)
    assert got.dtype == torch.int32
    assert torch.equal(got, pair_count_plain(T(ca), T(cb), pa, pb, vm))
    return got.numpy()


def _check(seq, active, n, ca, cb, pallas=True):
    """The port == both numpy oracles and (unless ``pallas`` is False)
    repro's interpreted Pallas kernel.  The Pallas kernel does not test
    ``ca < 0``: it relies on symbols being non-negative, so it is only
    asked where no valid slot holds a negative symbol."""
    got = _port(seq, active, n, ca, cb)
    np.testing.assert_array_equal(got, pair_count_ref(seq, active, n, ca, cb))
    np.testing.assert_array_equal(got, ref_jax(seq, active, n, ca, cb))
    if pallas:
        np.testing.assert_array_equal(
            got, np.asarray(pair_count_jax(seq, active, n, ca, cb,
                                           interpret=True)))
    return got


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_streams(seed):
    rng = np.random.default_rng(seed)
    n, Np = 700, 768
    seq, active = _stream(rng, n, Np, alphabet=30)
    ca, cb = _cands(rng, 256, 200, alphabet=30)
    got = _check(seq, active, n, ca, cb)
    assert got.sum() > 0


@pytest.mark.parametrize("negative_slots", [False, True])
def test_sentinels_and_duplicates(negative_slots):
    """``-1`` candidates count 0 — also, against the oracles, where valid
    slots hold -1 themselves; a candidate listed twice gets its full
    count in both slots."""
    rng = np.random.default_rng(3)
    n, Np = 400, 512
    seq, active = _stream(rng, n, Np, alphabet=8)
    if negative_slots:
        seq[5:9] = -1
        active[5:9] = True
    ca, cb = _cands(rng, 128, 40, alphabet=8)
    ca[40:50], cb[40:50] = ca[:10], cb[:10]        # duplicates
    ca[60], cb[60] = -1, int(seq[6])               # sentinel left only
    ca[61], cb[61] = int(seq[11]), -1              # right -1
    got = _check(seq, active, n, ca, cb, pallas=not negative_slots)
    np.testing.assert_array_equal(got[40:50], got[:10])
    assert got[60] == 0 and (got[:10] > 0).any()
    assert (got[62:] == 0).all()


def test_partial_candidate_tile():
    """K = 600: a 128- but not a 512-multiple (a partial tail tile on the
    TPU); and K = 37, no multiple of anything."""
    rng = np.random.default_rng(4)
    n, Np = 1000, 1024
    seq, active = _stream(rng, n, Np, alphabet=20)
    for K in (600, 37):
        ca, cb = _cands(rng, K, K - 5, alphabet=20)
        _check(seq, active, n, ca, cb)


def test_empty_and_all_invalid_streams():
    rng = np.random.default_rng(5)
    ca, cb = _cands(rng, 128, 100, alphabet=10)
    seq, active = _stream(rng, 128, 128, alphabet=10)
    # n = 0 and n = 1: no pair slot is inside the live length
    for n in (0, 1):
        assert not _check(seq, active, n, ca, cb).any()
    # no slot active
    assert not _check(seq, np.zeros(128, bool), 128, ca, cb).any()
    # a one-slot stream, and no stream at all (the port only)
    one = _port(np.asarray([3, 4], np.int32), np.ones(2, bool), 2,
                np.asarray([3, 4, 3], np.int32),
                np.asarray([4, 3, 4], np.int32))
    np.testing.assert_array_equal(one, [1, 0, 1])
    e = torch.zeros(0, dtype=torch.int32)
    assert not pair_count(T(ca), T(cb), e, e, e).any()
    assert pair_count(e, e, *pair_stream(T(seq), T(active), 128)).numel() == 0


def test_pair_stream_matches_repro():
    """The flat pair stream equals repro's tiled one, cut to length."""
    rng = np.random.default_rng(6)
    seq, active = _stream(rng, 900, 1000, alphabet=50)
    want = [np.asarray(x).reshape(-1)[:1000]
            for x in pair_stream_jax(seq, active, 900)]
    got = pair_stream(T(seq), T(active), 900)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), w)


def test_pair_keys_are_a_total_order():
    """Equal keys <=> equal int32 pairs, over the whole int32 range."""
    v = np.asarray([-2**31, -1, 0, 1, 2**31 - 1], np.int32)
    a, b = np.meshgrid(v, v)
    keys = pair_keys(T(a.ravel()), T(b.ravel()))
    assert torch.unique(keys).numel() == v.size ** 2


def test_builder_round_table_matches_pallas():
    """Round 1's real candidate table and pair stream of a cuda build
    (captured from the builder), counted by repro's Pallas kernel
    (interpreted) and by the port."""
    from repro_torch.build import cuda_builder, make_builder
    from strategies import small_lists

    seen = []
    real = cuda_builder.pair_count

    def capture(*args):
        seen.append([a.clone() for a in args])
        return real(*args)

    lists = small_lists(seed=9, n_lists=12, universe=600, max_len=100)
    cuda_builder.pair_count, saved = capture, cuda_builder.pair_count
    try:
        make_builder("cuda", device="cpu", table_cap=600).build_grammar(lists)
    finally:
        cuda_builder.pair_count = saved
    ca, cb, pa, pb, vm = seen[0]
    got = pair_count(ca, cb, pa, pb, vm).numpy()
    N = pa.shape[0]
    tile = lambda x: np.pad(x.numpy(), (0, -N % 512)).reshape(-1, 512)
    want = np.asarray(pair_count_pallas(ca.numpy(), cb.numpy(), tile(pa),
                                        tile(pb), tile(vm), interpret=True))
    np.testing.assert_array_equal(got, want)
    assert ca.shape[0] == 640 and (got[ca.numpy() >= 0] > 0).all()


def test_wrapper_checks_operands():
    t = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        pair_count(t.long(), t, t, t, t)
    with pytest.raises(ValueError, match="shape"):
        pair_count(t, t[:3], t, t, t)
    with pytest.raises(ValueError, match="shape"):
        pair_count(t, t, t, t, t[:2])
    meta = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        pair_count(meta, meta, meta, meta, meta)


@pytest.mark.parametrize("K, N, sms", [
    (4096, 954_112, 132), (1037, 300_001, 132), (1, 0, 132), (1, 5, 132),
    (600, 2048, 4), (8192, 954_112, 132), (32_768, 300_003, 132),
    (100_000, 10, 2)])
def test_count_plan(K, N, sms):
    """A chunk holds at most CHUNK candidates; a table has at least four
    times its keys in a power of two of 64 or more slots, and with the
    chunk's keys and counters (12 bytes each) fits Hopper's 227 KiB of
    shared memory per block; the grid has at most one block per SM and
    gives no block fewer than MIN_SLOTS_PER_BLOCK slots."""
    from repro_torch.kernels.pair_count import ops
    p = ops.count_plan(K, N, sms)
    chunks = -(-K // p.chunk)
    assert p.chunk <= ops.CHUNK and (chunks - 1) * p.chunk < K
    slots = 1 << p.bits
    assert slots >= max(64, 4 * p.chunk) and slots < max(128, 8 * p.chunk)
    assert 12 * p.chunk + 4 * slots <= 227 * 1024
    assert 1 <= p.blocks <= max(1, sms // chunks)
    assert p.blocks == 1 or N >= (p.blocks - 1) * ops.MIN_SLOTS_PER_BLOCK
    if (K, N, sms) == (4096, 954_112, 132):
        assert p == ops.CountPlan(4096, 14, 132)


def test_pair_slot_is_the_kernels_hash():
    """``pair_slot`` against the hash written out in Python integers, over
    the whole int32 range of both halves; the slots lie in the table and
    4,096 random keys spread over 16,384 slots with short probe runs."""
    from repro_torch.kernels.pair_count import ops
    rng = np.random.default_rng(8)
    a = rng.integers(0, 2**31, 500)
    b = rng.integers(-2**31, 2**31, 500)
    a[:3], b[:3] = (0, 2**31 - 1, 5), (-2**31, 2**31 - 1, -1)
    for bits in (6, 12, 13):
        got = ops.pair_slot(a, b, bits)
        for x, y, h in zip(a.tolist(), b.tolist(), got.tolist()):
            k = (x << 32) + (y & 0xFFFFFFFF)
            k ^= k >> 32
            k = (k * 0x9E3779B97F4A7C15) % 2**64
            assert h == k >> (64 - bits)
    keys = rng.integers(0, 20_000, (4096, 2))
    keys = np.unique(keys, axis=0)
    home = ops.pair_slot(keys[:, 0], keys[:, 1], 14)
    taken = np.zeros(1 << 14, bool)
    probes = []
    for h in home.tolist():                 # linear probing, in order
        p = 1
        while taken[h]:
            h, p = (h + 1) % (1 << 14), p + 1
        taken[h] = True
        probes.append(p)
    assert np.mean(probes) < 1.3 and max(probes) < 32



@pytest.mark.parametrize("K", [1, 600, 4096, 8192])
def test_colliding_keys_across_chunks(K):
    """The wrapper on CPU tensors on the card tests' hardest table: keys
    that crowd eight home slots of the kernel's table for K candidates
    (``count_plan``'s bits), copies of them in every chunk, and a stream
    half of hits, half of absent keys with the same home slots — against
    a numpy oracle that counts each key with ``np.unique``."""
    from repro_torch.kernels.pair_count import ops
    rng = np.random.default_rng(K)
    bits = ops.count_plan(K, 1, 132).bits
    a = rng.integers(0, 2**20, 400_000).astype(np.int32)
    b = rng.integers(-2**20, 2**20, 400_000).astype(np.int32)
    crowd = np.nonzero(ops.pair_slot(a, b, bits) < 8)[0]
    keys, absent = crowd[:min(K, 64)], crowd[64:128]
    take = rng.choice(keys, K)
    ca, cb = a[take], b[take]
    ca[rng.random(K) < 0.1] = -1
    pick = np.concatenate([rng.choice(keys, 5_000), rng.choice(absent,
                                                               5_000)])
    pa, pb = a[pick], b[pick]
    vm = (rng.random(pick.size) < 0.9).astype(np.int32)
    got = pair_count(T(ca), T(cb), T(pa), T(pb), T(vm)).numpy()
    key = pair_keys(T(pa), T(pb)).numpy()[vm != 0]
    uniq, cnt = np.unique(key, return_counts=True)
    want = dict(zip(uniq.tolist(), cnt.tolist()))
    ck = pair_keys(T(ca), T(cb)).numpy()
    np.testing.assert_array_equal(
        got, [0 if x < 0 else want.get(k, 0) for x, k in zip(ca, ck)])
    assert got.sum() > 0
