"""Each cell run as the benchmark runs it, on the card: ``python -m pytest
portbench/tests -m cuda`` there. Skipped without one."""

import json
import subprocess
import sys

import pytest
import torch

from portbench.core import spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_and_is_correct(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    done = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", name, "--seed",
         str(2 ** 32 + 3), "--seconds", "3", "--trace", "0"], cwd=spec.ROOT,
        capture_output=True, text=True, timeout=1500)
    assert done.returncode == 0, done.stderr[-4000:]
    r = json.loads(done.stdout.strip().splitlines()[-1])
    assert r["correct"], r["compared"]
    assert r["device"]["platform"] == "gpu" and r["attempted"] > 0
