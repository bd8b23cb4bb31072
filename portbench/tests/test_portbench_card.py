"""On the card: each cell runs a short window, correct, with its metrics
and no plain fallback; the control at the cell's own size is not
correct.  Skips without a CUDA device."""

import json
import subprocess
import sys

import pytest
import torch

from portbench.tests.tiny import CELLS, ROOT


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(name):
    _card()
    for trace in ("0", "1"):
        out = subprocess.run(
            [sys.executable, "-m", "portbench", "--workload", name, "--seed", str(2**31 + 77),
             "--seconds", "2", "--trace", trace],
            cwd=ROOT, capture_output=True, text=True, timeout=600, check=False,
        )
        assert out.returncode == 0, out.stderr[-3000:]
        result = json.loads(out.stdout.strip().splitlines()[-1])
        assert result["correct"], result["checks"]
        assert result["device"]["platform"] == "gpu"
        assert result["metrics"], result


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_on_the_card(name):
    _card()
    from portbench import control
    from portbench.spec import load_cell

    out = control.readings(load_cell(name, ROOT), 2**31 + 78, torch.device("cuda", 0), computes=20)
    assert not out["correct"], out["checks"]
