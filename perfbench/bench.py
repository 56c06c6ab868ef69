"""``BENCHMARK.json`` and the files it names, found by name.

Everything that belongs to one configuration, one traffic mix or one
metric is a file of its own, so a later change adds a cell by adding
files and entries and edits nothing:

* a configuration is the ``file`` its entry names (its sizes, the
  program's settings, the limits of the comparison);
* a traffic mix ``<name>`` is ``traffic/<name>.json``;
* a metric ``<name>``, end-to-end or per layer, is the reader
  ``metrics/<name>.py``, whose ``read(run)`` returns the metric's value
  from the run's record, or None where the run has nothing to read.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list[dict]
    per_layer: list[dict]
    readers: dict               # metric name -> its read(run)


def _applies(metric: dict, cell: str) -> bool:
    """A metric without a ``workloads`` list is every cell's."""
    return cell in metric.get("workloads", (cell,))


class Benchmark:
    def __init__(self, root: Path, spec: dict, here: Path = HERE):
        self.root, self.spec, self.here = Path(root), spec, Path(here)
        self.configs = {c["name"]: c for c in spec["configs"]}
        self.workloads = {w["name"]: w for w in spec["workloads"]}

    @classmethod
    def load(cls, root: Path, here: Path = HERE) -> "Benchmark":
        spec = json.loads((Path(root) / "BENCHMARK.json").read_text())
        return cls(root, spec, here)

    def traffic_path(self, name: str) -> Path:
        return self.here / "traffic" / f"{name}.json"

    def metric_path(self, name: str) -> Path:
        return self.here / "metrics" / f"{name}.py"

    def cell(self, name: str) -> Cell:
        try:
            w = self.workloads[name]
        except KeyError:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json; "
                             f"there are {sorted(self.workloads)}") from None
        c = self.configs[w["config"]]
        config = json.loads((self.root / c["file"]).read_text())
        traffic = json.loads(self.traffic_path(w["traffic"]).read_text())
        e2e = [m for m in self.spec["end_to_end"] if _applies(m, name)]
        layer = [m for m in self.spec["per_layer"] if _applies(m, name)]
        readers = {m["name"]: self.reader(m["name"]) for m in e2e + layer}
        return Cell(name, config, traffic, int(w["chips"]), e2e, layer,
                    readers)

    def reader(self, name: str):
        """The ``read`` function of metric ``name``."""
        path = self.metric_path(name)
        mod_name = "perfbench_metric_" + "".join(
            ch if ch.isalnum() else "_" for ch in name)
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    def problems(self) -> list[str]:
        """What a run of some cell would trip on: a file that is missing
        or does not parse, a metric without a reader."""
        out = []
        for name in self.workloads:
            try:
                cell = self.cell(name)
            except (OSError, ValueError, KeyError, AttributeError,
                    SyntaxError) as e:
                out.append(f"{name}: {e!r}")
                continue
            for key in ("corpus", "build", "index", "env", "limits",
                        "scoring"):
                if key not in cell.config:
                    out.append(f"{name}: configuration has no {key!r}")
            if cell.traffic.get("kind") not in ("bool", "topk"):
                out.append(f"{name}: traffic kind is not bool or topk")
        for m in self.spec["end_to_end"] + self.spec["per_layer"]:
            try:
                if not callable(self.reader(m["name"])):
                    out.append(f"{m['name']}: read is not callable")
            except (OSError, AttributeError, SyntaxError) as e:
                out.append(f"{m['name']}: {e!r}")
        return out
