"""The plain reference against the program's plain path on the CPU at a
tiny grid, for each traffic mix; and the comparison that decides
``correct`` catching the faults a cell can have."""
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from benchmark import harness  # noqa: E402

SMALL = {"sphere_384": {"dims": [16, 16, 16], "radius": 3,
                        "center": [7, 7, 7]},
         "tgv_384": {"dims": [16, 16, 16]}}
CELLS = ["sphere_384.static", "tgv_384.decay", "sphere_384.heave"]
QUICK = {"warmup_steps": 3}


def _run(cell, seed=2 ** 31 + 77, **kw):
    detail = {}
    config = harness.cell_files(harness.manifest(), cell)[0]["config"]
    out = harness.run(cell, seed, 0.05, False, device="cpu",
                      cfg_override=SMALL[config], mix_override=QUICK,
                      detail=detail, log=lambda *a, **k: None, **kw)
    return out, detail


@pytest.mark.parametrize("cell", CELLS)
def test_reference_equals_the_plain_path(cell):
    """Both sides run plain PyTorch on the CPU, the same operations in the
    same order: every compared number is 0."""
    out, detail = _run(cell)
    assert out["correct"]
    nums = detail["numbers"]
    assert set(out["check"]) <= set(nums)
    assert all(v == 0 for v in nums.values()), nums
    assert list(out)[-1] == "check"


def test_the_seed_draws_the_disturbance():
    """The same seed gives the same disturbance, another seed another."""
    from benchmark import traffic
    mix = harness.cell_files(harness.manifest(), "tgv_384.decay")[2]
    x = torch.rand(5, 3)

    def pert(seed):
        return traffic.perturbation(mix, seed, (16,) * 3, "cpu",
                                    torch.float32)(0, x)
    assert torch.equal(pert(2 ** 31 + 5), pert(2 ** 31 + 5))
    assert not torch.equal(pert(2 ** 31 + 5), pert(2 ** 31 + 6))


def _unchanged(cfg, levels, state):
    aux = {"pois_n": [1, 1], "dt": state.dt}
    return state, aux


def _altered(mom_step):
    def step(cfg, levels, state):
        new, aux = mom_step(cfg, levels, state)
        u = new.u.clone()
        u[(0,) + tuple(s // 2 for s in u.shape[1:])] += 1e-2
        return new.replace(u=u), aux
    return step


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_a_fault_is_not_correct(cell, fault, monkeypatch):
    """A step that returns its state unchanged, or a velocity altered where
    the step produces it, comes out not correct (the run stepping through
    the timed entry, the fault underneath it)."""
    from waterlily_tpu_torch import simulation
    broken = (_unchanged if fault == "unchanged"
              else _altered(simulation.mom_step))
    monkeypatch.setattr(simulation, "mom_step", broken)
    out, _ = _run(cell)
    assert not out["correct"]
