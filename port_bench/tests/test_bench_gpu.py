"""Each cell run briefly on the card through ``port_bench/run.py``, as the
benchmark's command runs it: a result line, correct, nothing failed. Skips
where there is no card (decided inside the test)."""

import json
import subprocess
import sys

import pytest

from .conftest import CELLS, ROOT


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("traced", [0, 1])
def test_cell_runs_on_the_card(name, traced):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run([sys.executable, "port_bench/run.py", "--workload", name,
                           "--seed", str(2**32 + 3), "--seconds", "2", "--trace", str(traced)],
                          cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    if traced:
        assert line["device"]["busy_s"] > 0 and line["breakdown"]["device_ops"]
