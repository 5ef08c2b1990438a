"""On the card: the tiny cell through the kernels is correct, and the
control and every planted fault fail. Skips where there is no card (it
decides inside the test); run on the card with
`python -m pytest portbench/tests -m card`."""

import time

import pytest
import torch

from portbench import faults, readings, run
from portbench.tests import _tiny


@pytest.mark.card
def test_tiny_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    out = run.execute(_tiny.cell(), 7, 0.01, 1, torch.device("cuda", 0),
                      time.time())
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0.0


@pytest.mark.card
def test_control_and_faults_fail_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    for row in readings.frame_readings(_tiny.cell(), [21, 22, 23],
                                       torch.device("cuda", 0), control=True,
                                       plant=True):
        assert row["program"]["correct"], row
        for name in ["control"] + sorted(faults.FRAME):
            assert not row[name]["correct"], (name, row)
