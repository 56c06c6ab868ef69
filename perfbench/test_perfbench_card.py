"""A short run of a cell on the card, as the benchmark's command runs it.

Marked ``cuda``: a fixture skips these where ``torch.cuda.is_available()``
is False.  On a machine with a card:

    python -m pytest -q -m cuda perfbench/test_perfbench_card.py
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")


def _run(*args):
    out = subprocess.run([sys.executable, "perfbench/run.py", *args],
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1]), out.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("trace", (0, 1))
def test_a_short_run_on_the_card(card, trace):
    res, err = _run("--workload", "repair.bool-c64", "--seed", "2147483659",
                    "--seconds", "3", "--trace", str(trace))
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert list(res)[-1] == "checks"
    assert err.strip().splitlines()[-1].startswith("check docs_wrong")
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        assert 0 < res["metrics"]["device.idle_pct"]["value"] < 100
        assert len(res["breakdown"]["device_ops"]) <= 10
    else:
        assert res["metrics"]["device_bits_per_posting"]["value"] > 0
