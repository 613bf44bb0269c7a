"""chip_smoke.py refuses to run without a CUDA device: it exits non-zero
and prints no result line."""
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="with a GPU the script runs the whole smoke")
def test_chip_smoke_exits_nonzero_without_gpu():
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout
    assert "needs a GPU" in proc.stderr


def test_chip_smoke_distributed_exits_nonzero_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("with a GPU the script runs phase 9")
    proc = subprocess.run([sys.executable, "chip_smoke.py", "--distributed"],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"scaleout"' not in proc.stdout and '"ok"' not in proc.stdout
    assert "needs a GPU" in proc.stderr
