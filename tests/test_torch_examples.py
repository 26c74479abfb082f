"""The port's examples (`waterlily_tpu_torch.examples`, twins of the JAX
package's ``examples/``) run to completion on the CPU with ``--quick``."""
import math

import numpy as np
import pytest
import torch

from waterlily_tpu_torch.examples import (three_d_sphere, two_d_circle,
                                          oscillating_plate, optimize_spin,
                                          ensemble_sweep, sharded_sphere)

CPU = ["--device", "cpu", "--quick"]


def test_three_d_sphere():
    sim = three_d_sphere.main(CPU)
    assert sim.sim_time >= 0.5 and torch.isfinite(sim.flow.u).all()
    assert sim.flow.u.device.type == "cpu"


def test_two_d_circle():
    rows = two_d_circle.main(CPU)
    assert len(rows) == 2 and np.all(np.isfinite(rows))
    assert all(1.0 < cd < 3.0 for _, cd, _ in rows)     # Cd of a circle


def test_oscillating_plate():
    rows = oscillating_plate.main(CPU)
    assert len(rows) == 2 and np.all(np.isfinite(rows))


@pytest.mark.parametrize("implicit", [False, True])
def test_optimize_spin(implicit):
    """Two descent iterations, and the loss falls."""
    losses = optimize_spin.main(CPU + (["--implicit"] if implicit else []))
    assert len(losses) == 2 and all(math.isfinite(v) for v in losses)
    assert losses[1] < losses[0]


def test_ensemble_sweep():
    """Three spinning cylinders in one batched program: a finite table,
    and |Cl| grows with the spin ratio."""
    rows = ensemble_sweep.main(CPU)
    assert len(rows) == 3 and np.all(np.isfinite(rows))
    lift = [abs(cl) for _, _, cl in rows]
    assert lift == sorted(lift) and lift[0] < lift[-1]


def test_sharded_sphere():
    """8 gloo ranks on the CPU, 3 steps of the (50,34,34) sphere on the
    (2,2,2) process mesh: dt and every pois_n equal the in-process mesh's
    (one thread on both sides)."""
    from waterlily_tpu_torch.models.cases import sphere_3d
    from waterlily_tpu_torch.parallel.mesh import mesh_for
    out = sharded_sphere.main(CPU + ["--backend", "gloo"])
    assert out["mesh"] == {"x": 2, "y": 2, "z": 2}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = sphere_3d(48, 32, device="cpu",
                        mesh=mesh_for(sharded_sphere.S, 8, "cpu"))
        ref.steps(3)
    finally:
        torch.set_num_threads(threads)
    assert out["dts"] == ref.dts and out["pois_n"] == ref.pois_n
    assert sharded_sphere.default_backend("cpu", 8) == "gloo"


def test_examples_default_to_the_card():
    args = optimize_spin.parser(optimize_spin.__doc__).parse_args([])
    assert args.device == "cuda" and not args.quick
