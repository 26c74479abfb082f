"""On the card, at each cell's own size: the program comes out correct and
its control does not.  The control is the program with its own lower
precision switched on (`readings.CONTROL`: bf16 search directions in the
pressure smoother).  Skips where there is no CUDA card."""
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from benchmark import harness, readings  # noqa: E402

CELLS = [w["name"] for w in harness.manifest()["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control's bf16 path runs on "
                    "the card's blocked levels only")
    return "cuda:0"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, card):
    quiet = dict(log=lambda *a, **k: None)
    sound = harness.run(cell, 2 ** 31 + 901, 2.0, False, device=card,
                        **quiet)
    control = harness.run(cell, 2 ** 31 + 902, 2.0, False, device=card,
                          options=readings.CONTROL, **quiet)
    assert sound["correct"], sound["check"]
    assert not control["correct"], control["check"]
