"""Baseline gap codecs the paper compares against (§5): byte codes (VByte,
as in [CM07]), Rice codes, and Elias gamma/delta, each with (a)-sampling
support and the same svs/merge/lookup intersection drivers.

All encoders work on the d-gaps of a strictly increasing list, head value
included as the first "gap" from a virtual -1 (so every gap is >= 1 even
when doc id 0 exists; decoders subtract the bias).  Sizes are reported in
bits, with byte codes rounded up to whole bytes per list, matching how the
paper accounts space.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np


# ---------------------------------------------------------------------------
# bit-stream helpers (numpy-vectorized where it matters)
# ---------------------------------------------------------------------------

class BitWriter:
    def __init__(self) -> None:
        self.bits: list[int] = []

    def write(self, value: int, nbits: int) -> None:
        for i in range(nbits - 1, -1, -1):
            self.bits.append((value >> i) & 1)

    def write_unary(self, q: int) -> None:
        self.bits.extend([1] * q)
        self.bits.append(0)

    def to_array(self) -> np.ndarray:
        return np.asarray(self.bits, dtype=np.uint8)


class BitReader:
    def __init__(self, bits: np.ndarray, pos: int = 0) -> None:
        self.bits = bits
        self.pos = pos

    def read(self, nbits: int) -> int:
        v = 0
        for _ in range(nbits):
            v = (v << 1) | int(self.bits[self.pos])
            self.pos += 1
        return v

    def read_unary(self) -> int:
        q = 0
        while self.bits[self.pos] == 1:
            q += 1
            self.pos += 1
        self.pos += 1
        return q


# ---------------------------------------------------------------------------
# VByte (byte codes, [CM07])
# ---------------------------------------------------------------------------

def vbyte_encode(gaps: np.ndarray) -> np.ndarray:
    out = bytearray()
    for g in gaps:
        g = int(g)
        while True:
            b = g & 0x7F
            g >>= 7
            if g:
                out.append(b)          # continuation: high bit clear
            else:
                out.append(b | 0x80)   # terminator: high bit set
                break
    return np.frombuffer(bytes(out), dtype=np.uint8)


def vbyte_decode(buf: np.ndarray, count: int, pos: int = 0) -> tuple[np.ndarray, int]:
    out = np.empty(count, dtype=np.int64)
    for i in range(count):
        v = 0
        shift = 0
        while True:
            b = int(buf[pos]); pos += 1
            v |= (b & 0x7F) << shift
            shift += 7
            if b & 0x80:
                break
        out[i] = v
    return out, pos


# ---------------------------------------------------------------------------
# Rice / Elias gamma / Elias delta
# ---------------------------------------------------------------------------

def rice_parameter(gaps: np.ndarray) -> int:
    """b ~ log2(mean gap): the classic choice (mean ~ u/l)."""
    mean = max(1.0, float(gaps.mean()) if gaps.size else 1.0)
    return max(0, int(np.floor(np.log2(mean))))


def rice_encode(gaps: np.ndarray, b: int) -> np.ndarray:
    w = BitWriter()
    for g in gaps:
        g = int(g) - 1  # gaps >= 1 -> encode g-1
        w.write_unary(g >> b)
        if b:
            w.write(g & ((1 << b) - 1), b)
    return w.to_array()


def rice_decode(bits: np.ndarray, count: int, b: int, pos: int = 0) -> tuple[np.ndarray, int]:
    r = BitReader(bits, pos)
    out = np.empty(count, dtype=np.int64)
    for i in range(count):
        q = r.read_unary()
        rem = r.read(b) if b else 0
        out[i] = ((q << b) | rem) + 1
    return out, r.pos


def gamma_encode(gaps: np.ndarray) -> np.ndarray:
    w = BitWriter()
    for g in gaps:
        g = int(g)
        nb = g.bit_length()
        w.write_unary(nb - 1)
        if nb > 1:
            w.write(g & ((1 << (nb - 1)) - 1), nb - 1)
    return w.to_array()


def gamma_decode(bits: np.ndarray, count: int, pos: int = 0) -> tuple[np.ndarray, int]:
    r = BitReader(bits, pos)
    out = np.empty(count, dtype=np.int64)
    for i in range(count):
        nb = r.read_unary() + 1
        low = r.read(nb - 1) if nb > 1 else 0
        out[i] = (1 << (nb - 1)) | low
    return out, r.pos


def delta_encode(gaps: np.ndarray) -> np.ndarray:
    w = BitWriter()
    for g in gaps:
        g = int(g)
        nb = g.bit_length()
        # gamma-code nb, then nb-1 low bits of g
        lb = nb.bit_length()
        w.write_unary(lb - 1)
        if lb > 1:
            w.write(nb & ((1 << (lb - 1)) - 1), lb - 1)
        if nb > 1:
            w.write(g & ((1 << (nb - 1)) - 1), nb - 1)
    return w.to_array()


def delta_decode(bits: np.ndarray, count: int, pos: int = 0) -> tuple[np.ndarray, int]:
    r = BitReader(bits, pos)
    out = np.empty(count, dtype=np.int64)
    for i in range(count):
        lb = r.read_unary() + 1
        nb = ((1 << (lb - 1)) | (r.read(lb - 1) if lb > 1 else 0))
        low = r.read(nb - 1) if nb > 1 else 0
        out[i] = (1 << (nb - 1)) | low
    return out, r.pos


# ---------------------------------------------------------------------------
# Encoded-lists container with (a)-sampling, mirroring the Re-Pair side API
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class EncodedLists:
    """One codec applied to every list.  Per list we keep the payload, the
    element count, and (a)-samples: every k-th *element* stores its absolute
    value and the payload offset where the next code starts ([CM07]'s
    <value, offset> pairs — offsets ARE needed here, unlike Re-Pair's
    (a)-sampling)."""

    name: str
    payloads: list[np.ndarray]
    counts: np.ndarray
    params: list[int]                  # per-list codec parameter (rice b)
    k: int
    sample_values: list[np.ndarray]
    sample_offsets: list[np.ndarray]
    universe: int
    unit_bits: int                     # 8 for vbyte payloads, 1 for bit codecs

    def size_bits(self, include_samples: bool = True) -> int:
        total = sum(int(p.size) * self.unit_bits for p in self.payloads)
        if include_samples:
            vb = max(1, int(np.ceil(np.log2(max(2, self.universe)))))
            for vals, offs, pl in zip(self.sample_values, self.sample_offsets,
                                      self.payloads):
                ob = max(1, int(np.ceil(np.log2(max(2, pl.size * self.unit_bits + 1)))))
                total += vals.size * (vb + ob)
        return total

    # decode list i fully
    def decode(self, i: int) -> np.ndarray:
        n = int(self.counts[i])
        if self.name == "vbyte":
            gaps, _ = vbyte_decode(self.payloads[i], n)
        elif self.name == "rice":
            gaps, _ = rice_decode(self.payloads[i], n, self.params[i])
        elif self.name == "gamma":
            gaps, _ = gamma_decode(self.payloads[i], n)
        elif self.name == "delta":
            gaps, _ = delta_decode(self.payloads[i], n)
        else:
            raise ValueError(self.name)
        return np.cumsum(gaps) - 1  # undo the head bias

    def next_geq_from(self, i: int, x: int, t: int) -> tuple[int | None, int]:
        """Smallest element >= x using sample bracket t onward; returns
        (value, new_bracket).  Decodes at most k codes past the bracket.
        Internally the stream stores biased values e+1; we bias x on entry
        and un-bias the answer."""
        x = int(x) + 1
        vals = self.sample_values[i]
        offs = self.sample_offsets[i]
        # gallop in samples from t
        n_s = vals.size
        step = 1
        hi = t
        while hi + step < n_s and vals[hi + step] < x:
            hi += step
            step <<= 1
        hi2 = min(n_s, hi + step + 1)
        t2 = int(np.searchsorted(vals[hi:hi2], x, side="left")) + hi
        t2 = max(0, min(t2, n_s - 1))
        if vals[t2] >= x:
            t2 = max(0, t2 - 1)
        # decode forward from sample t2
        start_elem = t2 * self.k
        base = int(vals[t2])
        pos = int(offs[t2])
        n = int(self.counts[i])
        remaining = n - start_elem
        if base >= x:
            return base - 1, t2
        if self.name == "vbyte":
            for _ in range(remaining):
                v = 0; shift = 0
                while True:
                    b = int(self.payloads[i][pos]); pos += 1
                    v |= (b & 0x7F) << shift; shift += 7
                    if b & 0x80:
                        break
                base += v
                if base >= x:
                    return base - 1, t2
        else:
            r = BitReader(self.payloads[i], pos)
            for _ in range(remaining):
                if self.name == "rice":
                    b = self.params[i]
                    q = r.read_unary()
                    rem = r.read(b) if b else 0
                    g = ((q << b) | rem) + 1
                elif self.name == "gamma":
                    nb = r.read_unary() + 1
                    g = (1 << (nb - 1)) | (r.read(nb - 1) if nb > 1 else 0)
                else:
                    lb = r.read_unary() + 1
                    nb = (1 << (lb - 1)) | (r.read(lb - 1) if lb > 1 else 0)
                    g = (1 << (nb - 1)) | (r.read(nb - 1) if nb > 1 else 0)
                base += g
                if base >= x:
                    return base - 1, t2
        return None, t2


def encode_lists(lists: Sequence[np.ndarray], codec: str, *, k: int = 32,
                 universe: int | None = None) -> EncodedLists:
    payloads: list[np.ndarray] = []
    counts = np.empty(len(lists), dtype=np.int64)
    params: list[int] = []
    svals: list[np.ndarray] = []
    soffs: list[np.ndarray] = []
    u = universe or max(int(pl[-1]) + 1 for pl in lists)
    unit = 8 if codec == "vbyte" else 1

    for i, pl in enumerate(lists):
        pl = np.asarray(pl, dtype=np.int64)
        gaps = np.diff(np.concatenate([[-1], pl]))  # head biased: gaps >= 1
        counts[i] = pl.size
        b = rice_parameter(gaps) if codec == "rice" else 0
        params.append(b)
        # encode and record the offset before every k-th element's code
        offsets = []
        if codec == "vbyte":
            out = bytearray()
            for j, g in enumerate(gaps):
                if j % k == 0:
                    offsets.append(len(out))
                g = int(g)
                while True:
                    byte = g & 0x7F
                    g >>= 7
                    if g:
                        out.append(byte)
                    else:
                        out.append(byte | 0x80)
                        break
            payloads.append(np.frombuffer(bytes(out), dtype=np.uint8))
        else:
            w = BitWriter()
            for j, g in enumerate(gaps):
                if j % k == 0:
                    offsets.append(len(w.bits))
                g = int(g)
                if codec == "rice":
                    gm = g - 1
                    w.write_unary(gm >> b)
                    if b:
                        w.write(gm & ((1 << b) - 1), b)
                elif codec == "gamma":
                    nb = g.bit_length()
                    w.write_unary(nb - 1)
                    if nb > 1:
                        w.write(g & ((1 << (nb - 1)) - 1), nb - 1)
                else:  # delta
                    nb = g.bit_length()
                    lb = nb.bit_length()
                    w.write_unary(lb - 1)
                    if lb > 1:
                        w.write(nb & ((1 << (lb - 1)) - 1), lb - 1)
                    if nb > 1:
                        w.write(g & ((1 << (nb - 1)) - 1), nb - 1)
            payloads.append(w.to_array())
        # sample j*k stores the value of element j*k-1 ("absolute value
        # preceding the sample") so scans start strictly before element j*k;
        # for j=0 the base is 0.
        csum = np.cumsum(gaps)
        sample_elem = np.arange(0, pl.size, k)
        vals = np.where(sample_elem == 0, 0, csum[np.maximum(sample_elem - 1, 0)])
        svals.append(vals.astype(np.int64))
        soffs.append(np.asarray(offsets, dtype=np.int64))

    return EncodedLists(
        name=codec, payloads=payloads, counts=counts, params=params, k=k,
        sample_values=svals, sample_offsets=soffs, universe=u, unit_bits=unit,
    )


def svs_encoded(short_ids: np.ndarray, enc: EncodedLists, i_long: int) -> np.ndarray:
    out: list[int] = []
    t = 0
    for x in short_ids:
        v, t = enc.next_geq_from(i_long, int(x), t)
        if v is None:
            break
        if v == int(x):
            out.append(int(x))
    return np.asarray(out, dtype=np.int64)
