"""One short run of the flat batch cell on the card, through the command
the driver runs. Skips without a CUDA card."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]


@pytest.mark.chip
def test_flat_batch_cell_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "flat-int8r-1m.batch256", "--seed",
                          "3000000017", "--seconds", "2", "--trace", "1"], cwd=REPO, capture_output=True,
                         text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert line["metrics"]["k2_roofline"]["value"] <= 105
