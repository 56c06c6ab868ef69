"""The traced run's readings: the device's activity from ``torch.profiler``
and what the host was doing, from a sampler of the main thread's stack.

``Tracer`` wraps a run's traced span.  At each end it launches a marker
kernel (``torch.cuda._sleep``) and notes the host clock, so the device's
timeline and the host's are tied together; the sampler records, every
``interval`` seconds, the innermost frame of the program (or else of the
benchmark) on the main thread.  ``summarize`` then reduces the trace to:

* ``busy_s`` — the union of every kernel, copy and fill on the device
  inside the window, and ``window_s`` its length;
* ``device_ops`` — device seconds by operation name, largest first;
* ``idle_gaps`` — the device's idle seconds by what the host was doing
  meanwhile, largest first;
* ``kernel_s`` — device seconds of the program's own kernels (by their
  ``__global__`` names).

The arithmetic (``merge``, ``busy_before``, ``idle_by_label``) is plain
functions, tested on the CPU; the tracer itself runs only on a card.
"""

from __future__ import annotations

import re
import sys
import threading
import time
from collections import Counter
from pathlib import Path

import numpy as np

#: the kernel ``torch.cuda._sleep`` launches: the timelines' tie points
MARKER = "spin_kernel"


def merge(intervals) -> np.ndarray:
    """The union of ``(start, end)`` intervals as sorted, disjoint rows."""
    iv = np.asarray(intervals, np.float64).reshape(-1, 2)
    if not iv.size:
        return iv
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    reach = np.maximum.accumulate(iv[:, 1])
    cut = np.flatnonzero(iv[1:, 0] > reach[:-1]) + 1
    first = np.concatenate([[0], cut])
    last = np.concatenate([cut - 1, [len(iv) - 1]])
    return np.stack([iv[first, 0], reach[last]], axis=1)


def busy_before(merged: np.ndarray, t) -> np.ndarray:
    """Busy time of ``merged`` (disjoint, sorted) before each time ``t``."""
    t = np.asarray(t, np.float64)
    if not merged.size:
        return np.zeros_like(t)
    lens = merged[:, 1] - merged[:, 0]
    cum = np.concatenate([[0.0], np.cumsum(lens)])
    i = np.searchsorted(merged[:, 0], t, side="right")     # started before t
    j = np.maximum(i - 1, 0)
    inside = np.clip(t - merged[j, 0], 0.0, lens[j])
    return cum[j] + np.where(i > 0, inside, 0.0)


def idle_by_label(merged: np.ndarray, samples, lo: float, hi: float
                  ) -> Counter:
    """Idle seconds of the device within ``[lo, hi]`` by the label of the
    host sample that opens each slice: ``samples`` is ``(time, label)``
    on the device's clock, in order."""
    out: Counter = Counter()
    ts = [lo] + [t for t, _ in samples if lo < t < hi] + [hi]
    labels = (["(before the first sample)"]
              + [lab for t, lab in samples if lo < t < hi])
    b = busy_before(merged, ts)
    for k, lab in enumerate(labels):
        idle = (ts[k + 1] - ts[k]) - (b[k + 1] - b[k])
        if idle > 0:
            out[lab] += idle
    return out


class HostSampler:
    """Samples the main thread's stack every ``interval`` seconds and
    names the innermost frame under one of ``roots`` (the first root
    that has one), as ``file.py:function``."""

    def __init__(self, roots, interval: float = 0.002):
        self.roots = [str(Path(r).resolve()) for r in roots]
        self.interval = interval
        self.samples: list[tuple[float, str]] = []
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._main = threading.main_thread().ident

    def label(self, frame) -> str:
        found = [None] * len(self.roots)
        while frame is not None:
            fn = frame.f_code.co_filename
            for k, root in enumerate(self.roots):
                if found[k] is None and fn.startswith(root):
                    found[k] = f"{Path(fn).name}:{frame.f_code.co_name}"
            frame = frame.f_back
        return next((f for f in found if f is not None), "(elsewhere)")

    def _run(self):
        while not self._stop.wait(self.interval):
            frame = sys._current_frames().get(self._main)
            self.samples.append((time.perf_counter(), self.label(frame)))

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="perfbench-sampler")
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            if self._thread.is_alive():
                raise RuntimeError("the host sampler did not stop")


class Tracer:
    """``torch.profiler`` over the window, with markers at both ends."""

    def __init__(self, device, roots):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.torch, self.device = torch, device
        self.sampler = HostSampler(roots)
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.marks: list[float] = []

    def _mark(self):
        torch = self.torch
        torch.cuda.synchronize(self.device)
        self.marks.append(time.perf_counter())
        with torch.cuda.device(self.device):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize(self.device)

    def start(self):
        self.prof.__enter__()
        self.sampler.start()
        self._mark()

    def stop(self):
        self._mark()
        self.sampler.stop()
        self.prof.__exit__(None, None, None)

    def device_events(self) -> list[tuple[str, float, float]]:
        """``(name, start_us, end_us)`` of every device activity.  Read from
        the profiler's raw results: building its per-event Python objects
        takes minutes for the million activities of a window."""
        from torch.autograd import DeviceType
        return [(e.name(), e.start_ns() / 1e3,
                 (e.start_ns() + e.duration_ns()) / 1e3)
                for e in self.prof.profiler.kineto_results.events()
                if e.device_type() == DeviceType.CUDA]

    def summarize(self, kernel_names) -> dict:
        evs = self.device_events()
        marks = sorted(s for n, s, _ in evs if MARKER in n)
        h0, h1 = self.marks
        if len(marks) >= 2:
            d0, d1 = marks[0], marks[-1]
            aligned = "marker kernels"
        else:
            d0 = min(s for _, s, _ in evs)
            d1 = d0 + (h1 - h0) * 1e6
            aligned = "first device activity (no marker kernel found)"
        evs = [(n, max(s, d0), min(e, d1)) for n, s, e in evs
               if e > d0 and s < d1 and MARKER not in n]
        merged = merge([(s, e) for _, s, e in evs])
        busy_us = float((merged[:, 1] - merged[:, 0]).sum())
        by_op: Counter = Counter()
        for n, s, e in evs:
            by_op[n] += e - s
        pat = re.compile(r"\b(" + "|".join(map(re.escape, kernel_names))
                         + r")\b") if kernel_names else None
        kernel_us = sum(us for n, us in by_op.items()
                        if pat is not None and pat.search(n))
        # host sample times onto the device clock: d0 is the first
        # marker's start, launched at host time h0
        samples = [(d0 + (t - h0) * 1e6, lab)
                   for t, lab in self.sampler.samples]
        idle = idle_by_label(merged, samples, d0, d1)
        return {
            "busy_s": busy_us / 1e6,
            "window_s": (d1 - d0) / 1e6,
            "kernel_s": kernel_us / 1e6,
            "device_activities": len(evs),
            "aligned_by": aligned,
            "device_ops": [[n[:160], us / 1e6]
                           for n, us in by_op.most_common(10)],
            "idle_gaps": [[f"host in {lab}", us / 1e6]
                          for lab, us in idle.most_common(10)],
        }
