"""The port stands alone and runs on the card unless asked otherwise.

* ``repro_torch`` — every submodule — imports in a fresh interpreter where
  ``jax``, ``repro`` and ``ml_dtypes`` (which ships with JAX) cannot be
  imported, and no file of the port (nor ``chip_smoke.py``) has an import
  statement naming any of them;
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
from repro_torch.kernels.bitmap_and import ops as K8
from repro_torch.kernels.bucket_intersect import ops as K7
from repro_torch.kernels.gap_decode import ops as K6
from repro_torch.kernels.grammar_expand import ops as K5
from repro_torch.kernels.list_intersect import ops as K1
from repro_torch.kernels.page_score import ops as K2
from repro_torch.launch import quickstart
from repro_torch.launch import serve as launch
from repro_torch.serve import QueryServer

ROOT = Path(__file__).resolve().parents[1]
PORT = Path(repro_torch.__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "repro", "ml_dtypes")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_imports_without_jax_or_repro():
    """Import every module of the port with ``jax``, ``repro`` and
    ``ml_dtypes`` blocked in ``sys.modules`` (any import of them raises
    ImportError)."""
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
        "print(' '.join(mods))\n")
    env = {"PYTHONPATH": f"{ROOT / 'src'}:{ROOT}", "PATH": "/usr/bin:/bin",
           "PYTHONDONTWRITEBYTECODE": "1"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    mods = set(out.stdout.split())
    assert len(mods) >= 40                          # every submodule imported
    assert {"repro_torch.build", "repro_torch.build.torch_builder",
            "repro_torch.build.cuda_builder", "repro_torch.build.host",
            "repro_torch.data", "repro_torch.data.pipeline",
            "repro_torch.index.builder", "repro_torch.core.optimize",
            "repro_torch.kernels.pair_count.ops",
            "repro_torch.kernels.grammar_expand.ops",
            "repro_torch.kernels.gap_decode.ops",
            "repro_torch.kernels.bucket_intersect.ops",
            "repro_torch.kernels.bitmap_and.ops", "repro_torch.index.hybrid",
            "repro_torch.index.positional",
            "repro_torch.launch.quickstart", "repro_torch.distributed",
            "repro_torch.distributed.sharding", "repro_torch.models",
            "repro_torch.models.layers", "repro_torch.models.moe",
            "repro_torch.models.transformer", "repro_torch.models.convert",
            "repro_torch.models.gnn", "repro_torch.models.recsys",
            "repro_torch.configs", "repro_torch.configs.base",
            "repro_torch.configs.yi_6b", "repro_torch.configs.repair_ir",
            "repro_torch.launch.specs", "repro_torch.serve.engine",
            "repro_torch.train", "repro_torch.train.optimizer",
            "repro_torch.train.checkpoint", "repro_torch.train.loop",
            "repro_torch.train.tree", "repro_torch.launch.train",
            "repro_torch.launch.train_lm",
            "repro_torch.launch.web_graph", "repro_torch.launch.mesh",
            "repro_torch.distributed.spmd",
            "repro_torch.distributed.pipeline",
            "repro_torch.launch.hlo_analysis",
            "repro_torch.launch.dryrun"} <= mods


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.name)
def test_no_import_statement_names_jax_or_repro(path):
    """Source check of every port file and of ``chip_smoke.py``: no
    ``import``/``from`` of ``jax``, ``jaxlib``, ``repro`` or ``ml_dtypes``
    (relative imports inside the port and ``repro_torch`` itself are
    fine)."""
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


def test_meta_mesh_only_where_named(no_card):
    """The dry run's meshes hold meta entries and need no card; the
    default (``"cuda"``) still raises without one, and ``resolve_device``
    refuses the meta device (no path from ``"cuda"`` to the CPU or to
    meta)."""
    from repro_torch.launch import dryrun, mesh
    m = mesh.make_production_mesh(multi_pod=True, device="meta")
    assert m.grid == (2, 16, 16) and {d.type for d in m.devices} == {"meta"}
    with pytest.raises(RuntimeError, match="is_available"):
        mesh.make_production_mesh()
    with pytest.raises(ValueError, match="unsupported device"):
        KR.resolve_device("meta")
    rec = dryrun.run_cell("deepfm", "serve_p99", False, verbose=False)
    assert rec["status"] == "ok" and rec["devices"] == 256


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


def test_codec_entry_points_raise_without_card(no_card, tiny_res):
    """The codec tier changes nothing about where the entry points run:
    without a card they raise before building anything, and with
    ``device="cpu"`` they serve through the plain versions."""
    with pytest.raises(RuntimeError, match="is_available"):
        QueryServer(tiny_res, codec="ef")
    with pytest.raises(RuntimeError, match="is_available"):
        make_engine("cuda", tiny_res, codec="adaptive")
    with pytest.raises(RuntimeError, match="is_available"):
        launch.serve_queries(4, num_docs=40, vocab=60, codec="ef")
    srv = QueryServer(tiny_res, device="cpu", codec="ef")
    assert srv.engine.tier.counts()["ef"] == tiny_res.num_lists
    np.testing.assert_array_equal(
        srv.search("2 AND 3"),
        np.intersect1d(tiny_res.decode_list(2), tiny_res.decode_list(3)))


def test_mesh_entry_points_raise_without_card(no_card, tiny_res):
    """A mesh of cards needs a card: the engine, the server and the
    launcher's ``--data-shards`` raise without one (nothing falls back to
    the CPU), and a CPU mesh serves with ``device="cpu"``."""
    from repro_torch.distributed import Mesh
    from repro_torch.engine import device as D
    with pytest.raises(RuntimeError, match="is_available"):
        QueryServer(tiny_res, mesh=Mesh(["cuda:0"]))
    with pytest.raises(RuntimeError, match="is_available"):
        make_engine("cuda", tiny_res, device="cpu",
                    mesh=Mesh(["cpu", "cuda:0"]))
    with pytest.raises(RuntimeError, match="is_available"):
        launch.serve_queries(4, num_docs=40, vocab=60, data_shards=1)
    with pytest.raises(SystemExit, match="available devices"):
        launch.serve_queries(4, engine="torch", device="cpu", num_docs=40,
                             vocab=60, data_shards=2)
    srv = QueryServer(tiny_res, device="cpu",
                      mesh=Mesh(["cpu"] * 2))
    D.reset_dispatches()
    np.testing.assert_array_equal(
        srv.search("0 AND 1", "svs"),
        np.intersect1d(tiny_res.decode_list(0), tiny_res.decode_list(1)))
    assert D.DISPATCHES["sharded_next_geq"] > 0


def test_build_entry_points_raise_without_card(no_card, tiny_res):
    """The device builders, ``QueryServer.rebuild`` with a builder named by
    string and the launcher's ``--builder`` default to the card: without
    one they raise before building, unless ``device="cpu"`` is passed."""
    from repro_torch.build import CudaBuilder, TorchBuilder, make_builder
    lists = [tiny_res.decode_list(i) for i in range(tiny_res.num_lists)]
    for name in ("cuda", "torch"):
        with pytest.raises(RuntimeError, match="is_available"):
            make_builder(name, table_cap=4096)
        with pytest.raises(RuntimeError, match="is_available"):
            launch.serve_queries(4, engine="host", num_docs=40, vocab=60,
                                 builder=name)
    for cls in (CudaBuilder, TorchBuilder):
        with pytest.raises(RuntimeError, match="is_available"):
            cls()
    srv = QueryServer(tiny_res, engine="host")
    with pytest.raises(RuntimeError, match="is_available"):
        srv.rebuild(lists)                          # torch builder, "cuda"
    cpu = QueryServer(tiny_res, device="cpu")
    res = cpu.rebuild(lists, builder="cuda")
    assert cpu.version == 1
    np.testing.assert_array_equal(res.seq, tiny_res.seq)


def test_resolve_device_rejects_other_devices():
    assert KR.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        KR.resolve_device("meta")


def test_wrappers_refuse_other_devices(tiny_res):
    """A tensor that is neither on the CPU nor on a card is refused: the
    plain versions run only because a tensor lies on the CPU."""
    # fully resident (store="" also under REPRO_STORE): the operand packs
    # of K1 and K2 hold the whole paged stream
    eng = make_engine("cuda", tiny_res, device="cpu", store="")
    meta = torch.device("meta")
    tables1 = {k: v.to(meta) for k, v in eng._tables.items()}
    lanes = [torch.zeros(8, dtype=torch.int32, device=meta)] * 4
    with pytest.raises(ValueError, match="unsupported device"):
        K1.paged_intersect(*lanes, tables1, **eng._statics)
    tables2, statics2 = K2.pad_score_operands(eng.pi)
    tables2 = {k: v.to(meta) for k, v in tables2.items()}
    ents = [torch.zeros(4, dtype=torch.int32, device=meta)] * 6
    with pytest.raises(ValueError, match="unsupported device"):
        K2.page_score(*ents, tables2, b_pad=128, **statics2)
    i32 = [torch.zeros(8, dtype=torch.int32, device=meta)] * 5
    with pytest.raises(ValueError, match="unsupported device"):
        K5.grammar_expand(*i32, max_depth=4)
    with pytest.raises(ValueError, match="unsupported device"):
        K6.gap_decode(torch.zeros((2, 4), dtype=torch.int32, device=meta),
                      i32[0][:2])
    with pytest.raises(ValueError, match="unsupported device"):
        K7.bucket_intersect(*[torch.zeros((2, 4), dtype=torch.int32,
                                          device=meta)] * 2)
    words = torch.zeros(8, dtype=torch.uint32, device=meta)
    for fn in (K8.bitmap_and, K8.bitmap_and_count):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(words, words)


def test_lm_entry_points_raise_without_card(no_card):
    """The LM tier runs on the card unless asked otherwise: the model, its
    initializer, the weight carrier, the engine and the launcher raise
    without one, and serve with ``device="cpu"``."""
    from repro_torch.configs import get_arch
    from repro_torch.models.convert import tensor_from_numpy
    from repro_torch.models.transformer import Transformer, init_params
    from repro_torch.serve import DecodeEngine, ServeConfig
    cfg = get_arch("yi-6b").smoke_config
    with pytest.raises(RuntimeError, match="is_available"):
        Transformer(cfg)
    with pytest.raises(RuntimeError, match="is_available"):
        init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="is_available"):
        tensor_from_numpy(np.zeros(3, np.float32))
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="is_available"):
        DecodeEngine(model, ServeConfig(max_batch=2, s_cache=16))
    with pytest.raises(RuntimeError, match="is_available"):
        launch.serve_lm("yi-6b", 2)
    eng = DecodeEngine(model, ServeConfig(max_batch=2, s_cache=16,
                                          max_new_tokens=3), device="cpu")
    eng.submit([3, 7, 11])
    assert [len(o) for o in eng.run_until_drained()] == [3]
    assert len(launch.serve_lm("minicpm3-4b", 3, device="cpu")) == 3


def test_train_entry_points_raise_without_card(no_card, tmp_path):
    """The training tier's entry points run on the card unless asked
    otherwise: ``launch/train.py --smoke``, ``launch/train_lm.py`` and
    ``launch/web_graph.py`` raise without one (nothing falls back to the
    CPU), and run with ``--device cpu``; the production mode of
    ``launch/train.py`` (the dry run, on meta entries) needs no card and
    returns its record."""
    from repro_torch.launch import train, train_lm, web_graph
    with pytest.raises(RuntimeError, match="is_available"):
        train.main(["--smoke", "--arch", "yi-6b", "--steps", "2",
                    "--ckpt-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="is_available"):
        train.smoke_train("yi-6b", 2, str(tmp_path))
    with pytest.raises(RuntimeError, match="is_available"):
        train_lm.main(["--steps", "2"])
    with pytest.raises(RuntimeError, match="is_available"):
        web_graph.main()
    rec = train.main(["--arch", "yi-6b", "--shape", "decode_32k"])
    assert rec["status"] == "ok" and rec["shape"] == "decode_32k"
    assert not (tmp_path / "step_0000000002").exists()
    tr = train.main(["--smoke", "--arch", "yi-6b", "--steps", "2",
                     "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    assert tr.device == torch.device("cpu") and len(tr.history) == 2


def test_distribution_entry_points_raise_without_card(no_card):
    """The mesh constructors and ``stack_mlp_params`` run on the card
    unless asked otherwise; on the CPU they run."""
    from repro_torch.distributed.pipeline import stack_mlp_params
    from repro_torch.launch import mesh as LM
    for make in (LM.make_production_mesh, lambda: LM.make_host_mesh(1, 2)):
        with pytest.raises(RuntimeError, match="is_available"):
            make()
    with pytest.raises(RuntimeError, match="is_available"):
        stack_mlp_params(torch.Generator().manual_seed(0), 2, 8)
    assert LM.make_host_mesh(2, 2, device="cpu").size == 1
    assert stack_mlp_params(torch.Generator().manual_seed(0), 2, 8,
                            device="cpu")["w"].shape == (2, 8, 8)


def test_quickstart_raises_without_card(no_card):
    """The quickstart flow runs on the card unless asked otherwise."""
    with pytest.raises(RuntimeError, match="is_available"):
        quickstart.main()


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
