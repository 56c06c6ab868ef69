"""The port stands alone and runs on the card unless asked otherwise.

* ``repro_torch`` — every submodule — imports in a fresh interpreter where
  ``jax`` and ``repro`` cannot be imported, and no file of the port (nor
  ``chip_smoke.py``) has an import statement naming either;
* the entry points default to ``device="cuda"`` and raise when no card is
  present, unless the caller passes ``device="cpu"``;
* a kernel wrapper serves a CPU tensor with the plain version and refuses
  a tensor on any device other than the CPU or a card.
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import kernels as KR
from repro_torch.core.repair import repair_compress
from repro_torch.engine import make_engine
from repro_torch.kernels.list_intersect import ops as K1
from repro_torch.kernels.page_score import ops as K2
from repro_torch.launch import serve as launch
from repro_torch.serve import QueryServer

ROOT = Path(__file__).resolve().parents[1]
PORT = Path(repro_torch.__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_imports_without_jax_or_repro():
    """Import every module of the port with ``jax`` and ``repro`` blocked
    in ``sys.modules`` (any import of them raises ImportError)."""
    code = (
        "import importlib, pkgutil, sys\n"
        f"for name in {FORBIDDEN!r}:\n"
        "    sys.modules[name] = None\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r} and sys.modules[m] is not None)\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    env = {"PYTHONPATH": f"{ROOT / 'src'}:{ROOT}", "PATH": "/usr/bin:/bin",
           "PYTHONDONTWRITEBYTECODE": "1"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 30       # every submodule imported


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.name)
def test_no_import_statement_names_jax_or_repro(path):
    """Source check of every port file and of ``chip_smoke.py``: no
    ``import``/``from`` of ``jax``, ``jaxlib`` or ``repro`` (relative
    imports inside the port and ``repro_torch`` itself are fine)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, \
                f"{path.name}:{node.lineno} imports {name}"


@pytest.fixture
def no_card(monkeypatch):
    """This process as it would be on a machine without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture(scope="module")
def tiny_res():
    rng = np.random.default_rng(0)
    return repair_compress([np.unique(rng.integers(0, 300, 40))
                            for _ in range(6)])


def test_cuda_entry_points_raise_without_card(no_card, tiny_res):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KR.resolve_device()
    for name in ("cuda", "torch"):
        with pytest.raises(RuntimeError, match="is_available"):
            make_engine(name, tiny_res)
        with pytest.raises(RuntimeError, match="is_available"):
            QueryServer(tiny_res, engine=name)
    with pytest.raises(RuntimeError, match="is_available"):
        QueryServer(tiny_res)                      # engine "cuda" by default
    with pytest.raises(RuntimeError, match="is_available"):
        launch.serve_queries(4, num_docs=40, vocab=60)
    # asked for explicitly, the CPU runs the plain versions
    srv = QueryServer(tiny_res, engine="cuda", device="cpu")
    assert srv.engine.device == torch.device("cpu")
    np.testing.assert_array_equal(
        srv.search("0 AND 1"),
        np.intersect1d(tiny_res.decode_list(0), tiny_res.decode_list(1)))


def test_resolve_device_rejects_other_devices():
    assert KR.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        KR.resolve_device("meta")


def test_wrappers_refuse_other_devices(tiny_res):
    """A tensor that is neither on the CPU nor on a card is refused: the
    plain versions run only because a tensor lies on the CPU."""
    eng = make_engine("cuda", tiny_res, device="cpu")
    meta = torch.device("meta")
    tables1 = {k: v.to(meta) for k, v in eng._tables.items()}
    lanes = [torch.zeros(8, dtype=torch.int32, device=meta)] * 4
    with pytest.raises(ValueError, match="unsupported device"):
        K1.list_intersect(*lanes, tables1, **eng._statics)
    tables2, statics2 = K2.pad_score_operands(eng.pi)
    tables2 = {k: v.to(meta) for k, v in tables2.items()}
    ents = [torch.zeros(4, dtype=torch.int32, device=meta)] * 6
    with pytest.raises(ValueError, match="unsupported device"):
        K2.page_score(*ents, tables2, b_pad=128, **statics2)


def test_build_needs_nvcc(monkeypatch, tmp_path):
    """Without a CUDA toolkit the build helper says what it looked for;
    library names follow the source and the flags."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(KR, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        KR.build_kernels()
    a = KR.library_path("list_intersect")
    assert a.parent == tmp_path / "build" and a.suffix == ".so"
    assert a != KR.library_path("page_score")
    monkeypatch.setattr(KR, "NVCC_FLAGS", KR.NVCC_FLAGS + ("-lineinfo",))
    assert KR.library_path("list_intersect") != a
