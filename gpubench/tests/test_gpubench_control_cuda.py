"""On the card: the control (the reference in TF32, put in the program's
place) comes out not correct against each cell's limits, and the program
comes out correct, at the cells' own sizes on three seeds (about four
minutes for the four cells; at the tiny sizes of ``tiny.py`` a 10- or
20-step chain leaves TF32's error too small to test the limits). Skips
without a card; ``python3 -m pytest -m cuda gpubench/tests`` on the chip
runs it."""

from __future__ import annotations

import pytest
import torch

from gpubench import harness
from gpubench.control import readings
from gpubench.tests import tiny

CELLS = ("textdiff_d2048.train_bs32", "mnist_unet.train_bs128",
         "mnist_unet.sample_n256", "textdiff_d2048.sample_n10")


@pytest.fixture
def card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setenv("TDM_FAST_NOISE", "1")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(card, cell):
    cell = harness.load_cell(tiny.REPO, cell)
    limits = cell.workload["limits"]
    for seed in (3, 2**31 + 5, 3_999_999_977):
        got = readings(cell, seed, card)
        assert all(got["program"][k] <= v for k, v in limits.items()), got
        assert any(got["control"][k] > v for k, v in limits.items()), got
