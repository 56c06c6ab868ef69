"""The benchmark stands apart from the JAX package, is driven by data, and
keeps to the contract of its ``BENCHMARK.json``.

* no module of the benchmark imports ``jax``, ``jaxlib``, ``flax`` or
  ``repro`` (top-level names compared whole: ``repro_torch`` is the
  port), by a scan of its import statements and by importing it, with
  every metric reader, and running a small cell in a fresh interpreter
  where those cannot be imported;
* a configuration, a traffic mix and a metric dropped into a copy of the
  benchmark as new files are found and validated by name, with no file
  that was there edited;
* ``run.py`` exits non-zero and prints no result without a card, and in
  a directory that holds only ``BENCHMARK.json`` and the benchmark.
"""

import ast
import hashlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench.bench import Benchmark

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _sources():
    return sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in
                  p.parts)


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_import_statement_names_jax_or_repro(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN, (path, n)


def test_runs_with_jax_and_repro_blocked():
    """Import every module and reader, then run a small cell on the CPU,
    with the forbidden names unimportable; none is loaded at the end."""
    code = f"""
import sys, time
for name in {FORBIDDEN!r}:
    sys.modules[name] = None
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
import importlib, pkgutil, perfbench
for m in pkgutil.walk_packages(perfbench.__path__, 'perfbench.'):
    if not m.name.split('.')[-1].startswith('test_'):
        importlib.import_module(m.name)
from perfbench.bench import Benchmark
from perfbench.harness import run_cell
b = Benchmark.load({str(ROOT)!r})
for m in b.spec['end_to_end'] + b.spec['per_layer']:
    b.reader(m['name'])
cell = b.cell('repair.bool-c64')
cell.config['corpus'].update(num_docs=300, vocab_size=400)
cell.traffic.update(warmup_queries=8, prefill=16)
out = run_cell(cell, 5, 0.5, False, t0=time.perf_counter(), device='cpu')
assert out['correct'], out['checks']
bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}
             and sys.modules[m] is not None)
assert not bad, bad
print('ok')
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=600,
                         env={"PATH": "/usr/bin:/bin",
                              "PYTHONDONTWRITEBYTECODE": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


def _digest(tree: Path) -> dict:
    return {p.relative_to(tree).as_posix(): hashlib.sha256(
        p.read_bytes()).hexdigest() for p in sorted(tree.rglob("*"))
        if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_are_found_by_name(tmp_path):
    """A later change adds a cell by adding files and entries: a new
    configuration, traffic mix and per-layer metric are listed, loaded
    and validated, and every file that was there is unchanged."""
    bench = tmp_path / "perfbench"
    shutil.copytree(HERE, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(bench)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((bench / "configs" / "zipf42k-repair.json").read_text())
    cfg.update(name="zipf5k-ef")
    cfg["index"]["codec"] = cfg["env"]["REPRO_CODEC"] = "ef"
    (bench / "configs" / "zipf5k-ef.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "topk10-c64.json").read_text())
    mix.update(clients=8, k=100)
    (bench / "traffic" / "topk100-c8.json").write_text(json.dumps(mix))
    (bench / "metrics" / "engine.lanes_per_dispatch.py").write_text(
        "def read(run):\n"
        "    n = run.delta('dispatches')\n"
        "    return run.delta('real_lanes') / n if n else None\n")
    spec["configs"].append({"name": "zipf5k-ef", "source": "x",
                            "file": "perfbench/configs/zipf5k-ef.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "ef.topk100-c8", "config": "zipf5k-ef",
                              "traffic": "topk100-c8", "chips": 1,
                              "why": "x"})
    spec["per_layer"].append({"name": "engine.lanes_per_dispatch",
                              "unit": "lanes", "better": "higher",
                              "source": "program_counter",
                              "layer": "engine", "moves": "qps"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    b = Benchmark.load(tmp_path, here=bench)
    assert b.problems() == []
    cell = b.cell("ef.topk100-c8")
    assert cell.config["index"]["codec"] == "ef"
    assert (cell.traffic["kind"], cell.traffic["k"]) == ("topk", 100)
    assert "engine.lanes_per_dispatch" in cell.readers
    # a metric without a workloads key goes to every cell, the old ones
    # too
    assert "engine.lanes_per_dispatch" in b.cell("repair.bool-c64").readers
    new = {"configs/zipf5k-ef.json", "traffic/topk100-c8.json",
           "metrics/engine.lanes_per_dispatch.py"}
    after = _digest(bench)
    assert set(after) - set(before) == new
    assert {k: after[k] for k in before} == before
    # and a missing file is named
    (bench / "metrics" / "engine.lanes_per_dispatch.py").unlink()
    assert any("lanes_per_dispatch" in p for p in b.problems())


def _spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_keeps_the_contract():
    spec = _spec()
    assert list(spec) == ["command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert spec["command"] == ["python3", "perfbench/run.py"]
    assert spec["paths"] == ["perfbench"]
    assert isinstance(spec["run_seconds"], int)
    assert 1 <= spec["run_seconds"] <= 51
    names = set()
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("perfbench/")
        assert (ROOT / c["file"]).is_file()
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert all(NAME.match(k) for k in c["reduced"])
        names.add(c["name"])
    used = set()
    pairs = set()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
    assert used == names
    cells = {w["name"] for w in spec["workloads"]}
    assert len(cells) == len(spec["workloads"])
    metric_names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in SOURCES
        assert 1 <= len(m["layer"]) <= 200
        assert set(m.get("workloads", cells)) <= cells
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
    b = Benchmark.load(ROOT)
    assert b.problems() == []
    for w in cells:
        cell = b.cell(w)
        assert "setup_s" in cell.readers and len(cell.end_to_end) >= 2
        assert cell.per_layer


def test_run_seconds_fits_the_check():
    spec = _spec()
    s = spec["run_seconds"]
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def _run(cwd: Path):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "repair.bool-c64",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=cwd, timeout=300,
        env={"PATH": "/usr/bin:/bin", "PYTHONDONTWRITEBYTECODE": "1"})


@pytest.fixture
def no_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")


def test_run_refuses_without_a_card(no_card):
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_run_refuses_with_only_the_benchmark(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
