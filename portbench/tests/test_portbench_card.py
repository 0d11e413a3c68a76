"""One cell on the card, as the benchmark's command runs it."""

import json
import subprocess
import sys

import pytest
import torch

from portbench.tests.helpers import ROOT


@pytest.mark.cuda
def test_pairs_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "surf_demo.pairs", "--seed", "5", "--seconds", "3",
                          "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
