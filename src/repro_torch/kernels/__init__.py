"""Hand-written CUDA kernels of the port, and what their wrappers share.

* ``list_intersect`` (K1) — batched ``next_geq`` over the paged Re-Pair
  stream: phrase-sum skipping + grammar descent, one thread per lane.
* ``page_score`` (K2) — block-max page-entry decode of ranked retrieval's
  ScoreRound, one block per directory entry.

Each kernel is CUDA C++ for ``sm_90a`` under ``repro_torch/csrc/``, built
on first use by ``nvcc`` into a shared library with a plain C interface
and loaded with ``ctypes``.  Libraries land in ``build_torch/`` at the
repository root, named by a hash of their source and flags, so a changed
source rebuilds and an unchanged one loads at once.

Every wrapper takes tensors on one device: on a CUDA tensor it launches
its kernel on the current stream (or raises); on a CPU tensor it runs the
kernel's plain PyTorch version.  ``LAUNCHES`` counts kernel launches per
kernel, so a run can show that its main path went through them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

KERNELS = ("list_intersect", "page_score")
SRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: kernel launches per kernel since the last :func:`reset_launches`
LAUNCHES = dict.fromkeys(KERNELS, 0)

_LIBS: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: ``"cuda"`` (the default of every
    entry point) or ``"cpu"``, which runs the kernels' plain versions.
    Raises when CUDA is asked for and absent — there is no quiet fallback
    to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain versions")
        return torch.device("cuda", torch.cuda.current_device()
                            if dev.index is None else dev.index)
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (str(Path(home) / "bin" / "nvcc"), shutil.which("nvcc")):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin and PATH)")


def library_path(name: str) -> Path:
    src = SRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_kernels(names=KERNELS) -> dict[str, str]:
    """Compile every named kernel that is not built yet — one ``nvcc``
    process per source, all started together — and return each one's
    compiler log (``-Xptxas -v``: registers, shared memory, spills).
    Raises with the log if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(SRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs = {}
    for name, (proc, tmp, out) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}.cu:\n{logs[name]}")
        os.replace(tmp, out)      # atomic: a reader never sees half a file
    return logs


def load_kernel(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed.  Its
    C interface is ``int <name>_launch(...)`` returning the launch's
    ``cudaGetLastError()`` and ``const char* <name>_error(int)``."""
    lib = _LIBS.get(name)
    if lib is None:
        build_kernels((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        getattr(lib, f"{name}_error").restype = ctypes.c_char_p
        getattr(lib, f"{name}_error").argtypes = [ctypes.c_int]
        _LIBS[name] = lib
    return lib


def check_operands(name: str, device: torch.device, **tensors) -> None:
    """Raise unless every tensor is contiguous int32 on ``device``."""
    for key, t in tensors.items():
        if t.device != device or t.dtype != torch.int32 \
                or not t.is_contiguous():
            raise ValueError(
                f"{name}: {key} must be a contiguous int32 tensor on "
                f"{device}, got {t.dtype} on {t.device}"
                f"{'' if t.is_contiguous() else ' (not contiguous)'}")


def launch(name: str, device: torch.device, argtypes: list, *args) -> None:
    """Call ``<name>_launch(*args, stream)`` on ``device``'s current CUDA
    stream, raise on a non-zero status, and count the launch."""
    lib = load_kernel(name)
    fn = getattr(lib, f"{name}_launch")
    fn.restype = ctypes.c_int
    fn.argtypes = [*argtypes, ctypes.c_void_p]
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        msg = getattr(lib, f"{name}_error")(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")
    LAUNCHES[name] += 1
