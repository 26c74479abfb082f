"""Port parity of `io` (torch vs JAX on the CPU): VTK ImageData files and
restart, npz checkpoints (bit for bit in the port, and across the two
packages in both directions) and the plots.

The JAX oracles are `test_io.py` (not its Orbax tests: the port keeps no
Orbax backend) and `test_plots.py`; each twin runs both packages on the
same inputs, a checkpoint written by one package restarting in the other
under the step-parity rule of `test_torch_sim.py`."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waterlily_tpu.body import AutoBody as JAutoBody
from waterlily_tpu.io import checkpoint as jck, vtk as jvtk
from waterlily_tpu.io import plots as jplots
from waterlily_tpu.metrics import curl as jcurl
from waterlily_tpu.models import cases as jcases
from waterlily_tpu.simulation import Simulation as JSimulation
import waterlily_tpu_torch as wt
from waterlily_tpu_torch.io import (save_checkpoint, load_checkpoint,
                                    restart_sim, VTKWriter, write_vti,
                                    read_vti, restart_from_vtk)
from waterlily_tpu_torch.io import plots as tplots
from waterlily_tpu_torch.metrics import curl

from _torch_parity import F32, F64, npy

f32 = jnp.float32


def _pois_ok(a, b):
    """Equal iteration counts, or within ±2 per solve and ≤4 in total."""
    a, b = np.asarray(a, int), np.asarray(b, int)
    d = np.abs(a - b)
    return bool((d == 0).all() or ((d <= 2).all() and d.sum() <= 4))


def _step_parity(a, b, n_hist):
    """The step-parity rule over the last ``n_hist`` steps: pois_n (±2/≤4),
    dt to 1e-5 relative, u and p to 1e-4."""
    pa = [[int(v) for v in r] for r in a.pois_n[-n_hist:]]
    pb = [[int(v) for v in r] for r in b.pois_n[-n_hist:]]
    assert _pois_ok(pa, pb), (pa, pb)
    np.testing.assert_allclose(a.dts[-n_hist:], b.dts[-n_hist:], rtol=1e-5)
    for k in ("u", "p"):
        np.testing.assert_allclose(npy(getattr(a.flow, k)),
                                   npy(getattr(b.flow, k)), atol=1e-4)


def sphere_sim(D=2, radius=8, torch_port=True):
    """The JAX test's sim: a circle (2D) or a sphere in a thin slab (3D)."""
    c = 2 * radius + 1.5
    dims = ((6 * radius, 4 * radius) if D == 2
            else (6 * radius, 4 * radius, radius))
    U = (1, 0) if D == 2 else (1, 0, 0)
    if torch_port:
        body = wt.AutoBody(lambda x, t: torch.sqrt(torch.sum((x - c) ** 2))
                           - radius)
        return wt.Simulation(dims, U, radius, body=body, nu=radius / 250,
                             device="cpu")
    body = JAutoBody(lambda x, t: jnp.sqrt(jnp.sum((x - c) ** 2)) - radius)
    return JSimulation(dims, U, radius, body=body, nu=radius / 250,
                       dtype=f32)


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("D", [2, 3])
def test_vti_roundtrip(tmp_path, D, dtype):
    """A .vti written by either package reads back bit for bit in both;
    the port writes tensors as well as arrays."""
    S = (8, 6) if D == 2 else (8, 6, 5)
    rng = np.random.default_rng(0)
    p = rng.normal(size=S).astype(dtype)
    u = rng.normal(size=(D,) + S).astype(dtype)
    ft, fj = str(tmp_path / "t.vti"), str(tmp_path / "j.vti")
    write_vti(ft, {"u": torch.from_numpy(u), "p": p})
    jvtk.write_vti(fj, {"u": u, "p": p})
    assert open(ft).read() == open(fj).read()
    for back in (read_vti(ft), read_vti(fj), jvtk.read_vti(ft)):
        for k, want in (("p", p), ("u", u)):
            assert back[k].dtype == want.dtype
            np.testing.assert_array_equal(back[k], want)


@pytest.fixture(scope="module")
def stepped2d():
    """The port's 2D sim stepped to tU/L = 0.02 (shared read-only)."""
    sim = sphere_sim(2)
    sim.sim_step(0.02)
    return sim


def _assert_vtk_restart(sim, restart):
    """u and p bit for bit and C-contiguous (the file is x-fastest; the
    kernels refuse other strides); μ₀ measured again, so to 1e-6."""
    assert restart.flow.u.is_contiguous() and restart.flow.p.is_contiguous()
    assert torch.equal(sim.flow.p, restart.flow.p)
    assert torch.equal(sim.flow.u, restart.flow.u)
    np.testing.assert_allclose(npy(sim.flow.mu0), npy(restart.flow.mu0),
                               atol=1e-6)
    assert abs(sim.sim_time - restart.sim_time) < 1e-3


@pytest.mark.parametrize("D", [2, 3])
def test_vtk_restart(tmp_path, D, stepped2d):
    os.chdir(tmp_path)
    if D == 2:
        sim = stepped2d
    else:
        sim = sphere_sim(3)
        sim.sim_step(0.02)
    wr = VTKWriter(f"test_vtk_reader_{D}", dir=str(tmp_path / "TEST_DIR"))
    wr.write(sim)
    wr.close()
    restart = sphere_sim(D)
    wr2 = restart_from_vtk(restart, f"test_vtk_reader_{D}.pvd")
    _assert_vtk_restart(sim, restart)
    assert wr2.count == 1 and wr2.entries == wr.entries


def test_vtk_restart_first_step_parity(tmp_path, stepped2d):
    """A restarted run takes its first step as the uninterrupted one does:
    Δt is ``cfl`` of the restored (bit-for-bit) u."""
    os.chdir(tmp_path)
    sim = sphere_sim(2)
    sim.sim_step(0.02)
    wr = VTKWriter("parity", dir=str(tmp_path / "PARITY_DIR"))
    wr.write(sim)
    restart = sphere_sim(2)
    restart_from_vtk(restart, "parity.pvd")
    assert np.isclose(float(restart.flow.dt), float(sim.flow.dt), rtol=1e-6)
    sim.step(remeasure=False)
    restart.step(remeasure=False)
    np.testing.assert_allclose(npy(sim.flow.u), npy(restart.flow.u),
                               atol=1e-5)
    np.testing.assert_allclose(npy(sim.flow.p), npy(restart.flow.p),
                               atol=1e-4)
    assert np.isclose(float(sim.flow.dt), float(restart.flow.dt), rtol=1e-5)


def test_vtk_restart_from_jax(tmp_path):
    """A JAX-written collection restarts the port: u and p bit for bit."""
    os.chdir(tmp_path)
    js = sphere_sim(2, torch_port=False)
    js.sim_step(0.02)
    wr = jvtk.VTKWriter("from_jax", dir=str(tmp_path / "J_DIR"))
    wr.write(js)
    ts = sphere_sim(2)
    restart_from_vtk(ts, "from_jax.pvd")
    np.testing.assert_array_equal(npy(ts.flow.u), np.asarray(js.flow.u))
    np.testing.assert_array_equal(npy(ts.flow.p), np.asarray(js.flow.p))
    assert abs(ts.sim_time - js.sim_time) < 1e-3


def test_checkpoint_roundtrip(tmp_path, stepped2d):
    """Every field, dt, t and the histories bit for bit, the next 3 steps
    bit for bit; JAX's keys."""
    sim = stepped2d
    f = str(tmp_path / "ckpt.npz")
    save_checkpoint(f, sim)
    data = load_checkpoint(f)
    assert set(data) == set(jck._FIELDS) | {"dts", "pois_n"}
    assert data["bbox"].dtype == np.int32 and not data["bbox"].any()
    assert data["pois_n"].shape == (len(sim.pois_n), 2)
    restart = restart_sim(sphere_sim(2), f)
    for k in ("u", "p", "V", "mu0", "mu1", "dt", "t"):
        assert torch.equal(getattr(sim.flow, k), getattr(restart.flow, k)), k
        assert getattr(restart.flow, k).is_contiguous(), k
    assert sim.dts == restart.dts and sim.pois_n == restart.pois_n
    a = restart_sim(sphere_sim(2), f)
    a.steps(3, remeasure=False)
    restart.steps(3, remeasure=False)
    assert a.pois_n == restart.pois_n and a.dts == restart.dts
    assert torch.equal(a.flow.u, restart.flow.u)
    assert torch.equal(a.flow.p, restart.flow.p)
    with pytest.raises(ValueError, match="grid"):
        restart_sim(wt.circle_2d(16, 16, device="cpu"), f)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_across_packages(tmp_path, writer):
    """A checkpoint written by one package restarts in the other: the
    reader's next 3 steps match the writer's own continuation under the
    step-parity rule."""
    f = str(tmp_path / f"{writer}.npz")
    src = sphere_sim(2, torch_port=writer == "torch")
    src.steps(3, remeasure=False)
    (save_checkpoint if writer == "torch" else jck.save_checkpoint)(f, src)
    dst = sphere_sim(2, torch_port=writer == "jax")
    (restart_sim if writer == "jax" else jck.restart_sim)(dst, f)
    assert len(dst.dts) == len(src.dts) and len(dst.pois_n) == 3
    np.testing.assert_array_equal(npy(dst.flow.u), npy(src.flow.u))
    np.testing.assert_array_equal(npy(dst.flow.mu0), npy(src.flow.mu0))
    # one `step` at a time: JAX's `steps` donates the state's buffers, and
    # the levels JAX's `restart_sim` builds share μ₀'s
    for _ in range(3):
        src.step(remeasure=False)
        dst.step(remeasure=False)
    _step_parity(dst, src, 3)


def test_checkpoint_bbox_recomputed_for_banded_sim(tmp_path):
    """A dense checkpoint restored into a banded sim: the window corner is
    recomputed from the body (zeros would park it at the domain corner),
    as JAX recomputes it, and the trajectory follows the dense restart."""
    a = wt.circle_2d(n=48, m=32, bbox=False, device="cpu")
    a.sim_step(0.02)
    f = str(tmp_path / "c.npz")
    save_checkpoint(f, a)
    b = restart_sim(wt.circle_2d(n=48, m=32, bbox="force", device="cpu"), f)
    assert all(v > 0 for v in b.flow.bbox), b.flow.bbox
    jb_ = jck.restart_sim(jcases.circle_2d(n=48, m=32, bbox="force"), f)
    assert b.flow.bbox == tuple(int(v) for v in np.asarray(jb_.flow.bbox))
    c = restart_sim(wt.circle_2d(n=48, m=32, bbox=False, device="cpu"), f)
    assert c.flow.bbox is None
    for _ in range(3):
        b.step(remeasure=False)
        c.step(remeasure=False)
    np.testing.assert_allclose(npy(b.flow.u), npy(c.flow.u), atol=2e-4)


def _plot_sims():
    js = sphere_sim(2, radius=4, torch_port=False)
    ts = sphere_sim(2, radius=4)
    return js, ts


def test_flood_and_body_plot(tmp_path):
    """`flood` of the same field draws the same contour levels in both
    packages; `body_plot` fills the same sdf."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    js, ts = _plot_sims()
    ts.sim_step()
    w = curl(2, ts.flow.u)
    fig, ax = plt.subplots()
    cs = tplots.flood(w, ax=ax)
    csj = jplots.flood(npy(w), ax=ax)
    np.testing.assert_array_equal(cs.levels, csj.levels)
    tplots.body_plot(ts, ax=ax)
    jplots.body_plot(js, ax=ax)
    out = str(tmp_path / "flood.png")
    fig.savefig(out)
    plt.close(fig)
    assert os.path.getsize(out) > 0
    np.testing.assert_array_equal(npy(curl(2, ts.flow.u)),
                                  np.asarray(jcurl(2, jnp.asarray(npy(
                                      ts.flow.u)))))


def test_sim_gif_smoke(tmp_path):
    """A 2-frame gif from both packages' tiny circle sims."""
    js, ts = _plot_sims()
    out = str(tmp_path / "smoke.gif")
    got = tplots.sim_gif(ts, out, duration=0.02, step=0.01, verbose=False,
                         plotbody=True)
    assert got == out and open(out, "rb").read(6) in (b"GIF87a", b"GIF89a")
    outj = str(tmp_path / "smoke_jax.gif")
    jplots.sim_gif(js, outj, duration=0.02, step=0.01, verbose=False)
    assert os.path.getsize(outj) > 0 and os.path.getsize(out) > 0


def test_residual_log_roundtrip(tmp_path):
    """`write_log` then `plot_logger` on the port; JAX's `plot_logger`
    reads the port's log too."""
    ts = wt.circle_2d(32, 32, device="cpu", log=True)
    ts.step(remeasure=False)
    ts.steps(2, remeasure=False)
    logf = str(tmp_path / "WaterLily.log")
    ts.write_log(logf)
    txt = open(logf).read()
    assert txt.startswith("p/c, iter")
    assert txt.count("\np\n") == 3 and txt.count("\nc\n") == 3
    pred, corr = tplots.read_log(logf)
    assert [len(s) - 1 for s in pred] == [n[0] for n in ts.pois_n]
    assert [len(s) - 1 for s in corr] == [n[1] for n in ts.pois_n]
    png = tplots.plot_logger(logf, out=str(tmp_path / "res.png"))
    assert os.path.getsize(png) > 0
    pngj = jplots.plot_logger(logf, out=str(tmp_path / "res_jax.png"))
    assert os.path.getsize(pngj) > 0


def test_recording_path_imports_without_jax_or_matplotlib(tmp_path):
    """The recording path never imports jax, waterlily_tpu or matplotlib
    (the H100 machine has no matplotlib): with the three made
    unimportable, a tiny logged sim records, writes its log, a checkpoint
    and a snapshot, and restarts."""
    import subprocess
    import sys
    from pathlib import Path
    code = (
        "import sys\n"
        "for m in ('jax', 'waterlily_tpu', 'matplotlib'):\n"
        "    sys.modules[m] = None\n"
        "import waterlily_tpu_torch as wt\n"
        "from waterlily_tpu_torch import io, metrics\n"
        "from waterlily_tpu_torch.io import plots\n"
        "sim = wt.circle_2d(16, 16, device='cpu', log=True)\n"
        "rec = sim.run_record(0.2, every=0.1, fields={'f': lambda s: "
        "metrics.total_force(s.flow.u, s.flow.p, s.cfg.nu, s.body, s.time,"
        " 'extrap')})\n"
        "sim.write_log('w.log')\n"
        "io.save_checkpoint('c.npz', sim)\n"
        "io.write_vti('s.vti', {'u': sim.flow.u, 'p': sim.flow.p})\n"
        "io.restart_sim(wt.circle_2d(16, 16, device='cpu'), 'c.npz')\n"
        "print('ok', len(rec['t']), len(plots.read_log('w.log')[0]))\n")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=300, cwd=tmp_path,
        env={**os.environ, "PYTHONPATH": str(Path(__file__).resolve()
                                             .parent.parent)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
