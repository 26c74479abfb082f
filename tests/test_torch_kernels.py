"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``: without a CUDA device every case skips.  On a GPU machine
(which need not have JAX) run them with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

The kernels build from ``waterlily_tpu_torch/csrc`` at first use.
"""
import dataclasses
import itertools

import pytest
import torch

from _pcg_chain import FOLD_CASES, chain, fold_case

pytestmark = pytest.mark.cuda

# the slice's shapes: the (96,64,64) fine level, a non-cubic shape whose
# cell count leaves a ragged last block, and the PCG kernel's level
FINE = (98, 66, 66)
RAGGED = (37, 29, 35)
STENCILS = ["mult3d", "increment3d", "cfl3d", "bc3d", "div3d", "project3d",
            "conv_diff3d"]
# the blocked-level PCG iteration (ops/attic.py) and its composite smoother
PCG_ITERATION = ["pcg_dir_mult", "pcg_update", "dot3d", "pcg_axpy",
                 "pcg_blocked"]
# the carried-rows operator (ops/attic.py) and the bandwidth probes
# (kernels/probes.py)
STREAMS = ["mult3d_stream", "increment3d_stream"]
PROBES = ["copy_probe", "roll_probe"]
# conv_diff3d's (8, 32) column tiles and axis-0 chunks (of 4 to 64 planes)
# cut raggedly, and an axis 0 shorter than the shortest chunk
CONV_RAGGED = [RAGGED, (70, 41, 67), (3, 37, 70)]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _check(name, S, device):
    from waterlily_tpu_torch.kernels.check import compare
    rows = compare(name, S, 1, device)
    bad = [r for r in rows if not r["ok"]]
    assert not bad, bad


@pytest.mark.parametrize("name", STENCILS)
@pytest.mark.parametrize("S", [FINE, RAGGED])
def test_stencil_kernel_matches_plain(name, S, device):
    _check(name, S, device)


@pytest.mark.parametrize("name", PCG_ITERATION)
@pytest.mark.parametrize("S", [FINE, RAGGED])
def test_pcg_iteration_kernel_matches_plain(name, S, device):
    """Every form (f32 and bf16 directions, beta 0 and not, the three dot
    modes): elementwise outputs exact, sums within 1e-5 relative,
    pcg_blocked within 1e-5 of the per-pass pcg."""
    _check(name, S, device)


def test_bf16_forms_launch_and_refuse(device):
    """mult3d and increment3d launch on a bf16 x / eps and on a bf16 L (a
    level's L16; their values are held by the cases above) and record the
    forms; a bf16 D, L16 without iD16 in pcg_dir_mult and a bf16 b in
    dot3d's ab mode raise."""
    from waterlily_tpu_torch.kernels.check import inputs
    from waterlily_tpu_torch.ops import stencil_kernels as sk
    from waterlily_tpu_torch.ops import attic as at
    d = inputs(FINE, 0, device)
    L, Dd, x16 = d["lev"].L, d["lev"].D, d["x"].to(torch.bfloat16)
    n_mult = sk.mult3d.launches
    z = sk.mult3d(L, Dd, x16)
    z16 = sk.mult3d(d["L16"], d["D16"], d["x"])
    assert z.dtype == z16.dtype == torch.float32
    assert sk.mult3d.launches == n_mult + 2
    assert {("x",), ("L",)} <= sk.mult3d.forms
    with pytest.raises(TypeError, match="float32"):
        sk.mult3d(d["L16"], d["D16"].to(torch.bfloat16), d["x"])
    with pytest.raises(TypeError, match="iD16"):
        at.pcg_dir_mult(d["L16"], d["D16"], d["eps"], d["r"], d["lev"].iD)
    with pytest.raises(TypeError, match="float32"):
        at.dot3d(d["x"], d["iD16"], "ab")


@pytest.mark.parametrize("name", STREAMS)
@pytest.mark.parametrize("S", [FINE, RAGGED, (7, 9, 40), (65, 3, 33)])
def test_stream_kernel_matches_plain(name, S, device):
    """The carried-rows operator with and without the dot, f32 and bf16 L,
    at every shape (ragged tiles and chunks, a one-column interior): z, x
    and r exact, the dot within 1e-5 relative."""
    _check(name, S, device)


@pytest.mark.parametrize("name", PROBES)
@pytest.mark.parametrize("S", [FINE, RAGGED])
def test_probe_matches_plain(name, S, device):
    """The bandwidth probes exact (RAGGED's cell count leaves the copy a
    tail of three cells)."""
    _check(name, S, device)


def test_stream_seam_launches_and_refuses(device, monkeypatch):
    """Under ``poisson.STREAM`` a blocked level's mult, residual, increment
    and pcg launch the carried-rows kernels and not the halo-row ones, on
    the f32 operator and on the shadows; a level the kernel cannot take
    (f64) raises."""
    import dataclasses
    from waterlily_tpu_torch.kernels.check import inputs
    from waterlily_tpu_torch.ops import poisson
    from waterlily_tpu_torch.ops import stencil_kernels as sk
    from waterlily_tpu_torch.ops import attic as at
    d = inputs(FINE, 0, device)
    monkeypatch.setattr(poisson, "STREAM", True)
    lev, r = d["lev"], d["r"]
    lev16 = poisson.make_level(lev.L, op_bf16=True)
    assert lev.blocked and lev16.L16 is not None
    counts = lambda: (sk.mult3d.launches, sk.increment3d.launches,
                      at.mult3d_stream.launches,
                      at.increment3d_stream.launches)
    for lv in (lev, lev16):
        before = counts()
        poisson.residual(lv, d["x"], r)
        poisson.increment(lv, d["x"], r, d["eps"])
        poisson.pcg(lv, torch.zeros_like(r), r, it=2)
        after = counts()
        assert after[:2] == before[:2]
        assert after[2] == before[2] + 3 and after[3] == before[3] + 1
    assert ("L",) in at.mult3d_stream.forms
    bad = dataclasses.replace(lev, L=lev.L.double(), D=lev.D.double())
    with pytest.raises(TypeError, match="float32"):
        poisson.mult(bad, d["x"].double())


@pytest.mark.parametrize("S", [(50, 34, 34), (23, 17, 29), (34, 34, 34),
                               (10, 10, 10)])
def test_pcg_kernel_matches_plain(S, device):
    """Walls and periodic axes (0, 1, 2), within 1e-5."""
    _check("pcg_fused", S, device)


@pytest.mark.parametrize("S", [(98, 66), (50, 34), (37, 29), (10, 14)])
def test_pcg_kernel_2d_matches_plain(S, device):
    """The 2D smooth: walls and periodic axes (1,) and (0, 1), within
    1e-5 (the 2D circle's levels, a ragged shape, JAX's test shape)."""
    _check("pcg_fused", S, device)


@pytest.mark.parametrize("S", [(258, 258, 258), FINE, RAGGED, (35, 37, 31)])
def test_bc3d_both_forms_match_plain(S, device):
    """bc3d, exact against the plain form in all 16 periodic/save_exit
    forms (each filling its own copy in place): 258³, the dense slice, and
    ragged shapes."""
    _check("bc3d", S, device)


@pytest.mark.parametrize("S", [FINE, RAGGED])
def test_bc3d_inplace_fills_its_input(S, device):
    """In place, bc3d returns the tensor it was given, filled as the
    copying form (the kernel on a clone) fills a new one; the copying form
    leaves its input and equals the plain form, in all 16 forms;
    Dirichlet values as numbers or as device scalars give the same bits."""
    from waterlily_tpu_torch.kernels.check import inputs, BC_PERDIRS
    from waterlily_tpu_torch.ops import stencil_kernels as sk
    from waterlily_tpu_torch.ops.bc import bc_vector_planes
    u = inputs(S, 0, device)["u"]
    u0 = u.clone()
    # Dirichlet values as numbers (passed with the launch) and as device
    # scalars (a time-dependent U: read from a device array)
    A_dev = tuple(torch.tensor(a, device=device) for a in (1.0, 0.5, 0.0))
    for perdir, save_exit in itertools.product(BC_PERDIRS, (False, True)):
        ref = sk.bc3d(u, (1.0, 0.5, 0.0), save_exit, perdir)
        assert torch.equal(u, u0)
        assert torch.equal(ref, bc_vector_planes(u, (1.0, 0.5, 0.0),
                                                 save_exit, perdir))
        assert torch.equal(sk.bc3d(u, A_dev, save_exit, perdir), ref)
        for A in ((1.0, 0.5, 0.0), A_dev):
            v = u.clone()
            out = sk.bc3d(v, A, save_exit, perdir, inplace=True)
            assert out is v and torch.equal(v, ref)
    assert {"inplace", "copy"} <= sk.bc3d.forms


@pytest.mark.parametrize("S", [(50, 34, 34), (34, 34, 34), (10, 10, 10),
                               (98, 66), (50, 34)])
def test_pcg_kernel_is_deterministic(S, device):
    """Two calls give the same bits, on a grid of blocks and on one block
    (3D walls and periodic, 2D walls and periodic): the level's sums are
    added in one order in every block."""
    from waterlily_tpu_torch.kernels.check import inputs, PCG_PERDIRS
    from waterlily_tpu_torch.ops import pcg_kernel as pk
    d = inputs(S, 0, device)
    for perdir in ((),) + PCG_PERDIRS[len(S)]:
        lev, r = d["level"](perdir)
        x0 = d["x"]
        one, two = pk.pcg_fused(lev, x0, r), pk.pcg_fused(lev, x0, r)
        for a, b in zip(one, two):
            assert torch.equal(a, b), (S, perdir)


@pytest.mark.parametrize("S", [FINE, RAGGED])
def test_ana_mult3d_matches_plain(S, device):
    """c = 1 and 2, with and without the dot, and a periodic axis."""
    _check("ana_mult3d", S, device)


@pytest.mark.parametrize("S", [FINE, RAGGED])
def test_periodic_and_exit_forms_launch(S, device):
    """The periodic and save_exit bc3d, the periodic conv_diff3d and the
    2D and periodic pcg_fused launch their kernels on CUDA tensors (their
    values are held by the cases above); f64 still raises (bf16 and f64
    streams are not kernel forms)."""
    from waterlily_tpu_torch.kernels.check import inputs
    from waterlily_tpu_torch.ops import stencil_kernels as sk
    from waterlily_tpu_torch.ops import pcg_kernel as pk
    from waterlily_tpu_torch.ops import convect
    u = inputs(S, 0, device)["u"]
    n_bc, n_conv = sk.bc3d.launches, sk.conv_diff3d.launches
    sk.bc3d(u, (0.0, 0.0, 0.0), perdir=(0,))
    sk.bc3d(u, (1.0, 0.0, 0.0), save_exit=True)
    sk.conv_diff3d(u, 0.01, convect.quick, perdir=(1,))
    assert sk.bc3d.launches == n_bc + 2
    assert sk.conv_diff3d.launches == n_conv + 1
    d2 = inputs((10, 14), 0, device)
    lev, r = d2["level"]((1,))
    n_pcg = pk.pcg_fused.launches
    pk.pcg_fused(lev, torch.zeros_like(r), r)
    assert pk.pcg_fused.launches == n_pcg + 1
    with pytest.raises(TypeError, match="float32"):
        sk.cfl3d(u.double())


@pytest.mark.parametrize("S", CONV_RAGGED)
def test_conv_diff3d_ragged_tiles_and_chunks(S, device):
    """The plane-marching conv_diff3d exact against its plain form, QUICK,
    van Leer and a user-defined limiter, walls and all seven periodic
    masks."""
    _check("conv_diff3d", S, device)


@pytest.mark.parametrize("S", [FINE, RAGGED])
def test_dot3d_is_deterministic(S, device):
    """Two calls on one input give the same bits in every mode (the last
    block sums the partials in index order; no atomics in the sum)."""
    from waterlily_tpu_torch.kernels.check import inputs
    from waterlily_tpu_torch.ops import attic as at
    d = inputs(S, 0, device)
    r, iD = d["r"], d["lev"].iD
    for a, b, mode in ((r, r, "aa"), (d["x"], d["eps"], "ab"),
                       (r, iD, "rid"), (r, d["iD16"], "rid")):
        one, two = at.dot3d(a, b, mode), at.dot3d(a, b, mode)
        assert one.shape == () and torch.equal(one, two), (mode, one, two)


def test_user_limiter_steps_through_the_conv_kernel(device):
    """``sphere_3d(96, 64)`` with a user-defined limiter steps on the card
    through `conv_diff3d` with the limiter traced in (its values are held
    exact by the cases above) and stays finite; a limiter with no kernel
    form raises on the card."""
    from waterlily_tpu_torch import sphere_3d
    from waterlily_tpu_torch.kernels.check import minmod
    from waterlily_tpu_torch.ops import stencil_kernels as sk

    sim = sphere_3d(96, 64, limiter=minmod, device=device)
    n = sk.conv_diff3d.launches
    sk.conv_diff3d.forms.clear()
    sim.steps(2, remeasure=False)
    assert sk.conv_diff3d.launches == n + 4
    assert sk.conv_diff3d.forms == {"minmod"}
    for t in (sim.flow.u, sim.flow.p):
        assert bool(torch.isfinite(t).all())
    with pytest.raises(NotImplementedError):
        sk.conv_diff3d(sim.flow.u, 0.01, lambda u, c, d: c + torch.exp(d))


# the plane-marching reductions' ragged cases: an axis 0 of one and two
# interior planes, axes 1 and 2 off their (8, 32) column tiles, and
# 8 chunks of 9 interior planes over 65 (the last one of 2)
MARCH_RAGGED = [(3, 37, 70), (4, 9, 40), (37, 29, 35), (70, 41, 67),
                (67, 130, 130)]


@pytest.mark.parametrize("name", ["cfl3d", "ana_mult3d"])
@pytest.mark.parametrize("S", MARCH_RAGGED)
def test_march_kernels_ragged(name, S, device):
    """cfl3d exact, and every ana_mult3d form exact against its plain form
    (z with the dot at c = 1; c = 2 with walls and each periodic mask),
    the dot within 1e-5 relative."""
    _check(name, S, device)


@pytest.mark.parametrize("S", [(37, 29, 35), (70, 41, 67)])
def test_march_kernels_ragged_chunks(S, device, monkeypatch):
    """Chunks of 3 interior planes, the last one shorter: still exact."""
    from waterlily_tpu_torch.ops import stencil_kernels as sk
    monkeypatch.setattr(sk, "MARCH_PLANES", (3, 3))
    _check("cfl3d", S, device)
    _check("ana_mult3d", S, device)


@pytest.mark.parametrize("S", [FINE, (3, 37, 70), (37, 29, 35)])
def test_ana_mult3d_dot_is_deterministic(S, device):
    """Two calls on one input give the same bits, z and the dot (the last
    block sums the partials in index order; no atomics in the sum)."""
    from waterlily_tpu_torch.kernels.check import inputs
    from waterlily_tpu_torch.ops import stencil_kernels as sk
    x = inputs(S, 0, device)["x"]
    for c, perdir in ((1.0, ()), (2.0, (0, 1, 2))):
        (z1, d1), (z2, d2) = (sk.ana_mult3d(x, c, perdir, True),
                              sk.ana_mult3d(x, c, perdir, True))
        assert d1.shape == () and torch.equal(d1, d2), (c, perdir, d1, d2)
        assert torch.equal(z1, z2)


@pytest.mark.parametrize("S", [FINE, (3, 37, 70), (37, 29, 35)])
def test_cfl3d_nan(S, device):
    """A NaN in a ghost cell that no interior term reads (u₀ on the plane
    i = 0) is ignored, as by the plain form; one in an interior cell comes
    out.  (The +δ taps do read the ghost plane S−1, as the plain form
    does: the exact cases above hold that.)"""
    from waterlily_tpu_torch.kernels.check import inputs
    from waterlily_tpu_torch.ops import stencil_kernels as sk
    u = inputs(S, 0, device)["u"].clone()
    u[0, 0, 1, 1] = float("nan")
    got = sk.cfl3d(u)
    assert bool(torch.isfinite(got)) and torch.equal(got,
                                                     sk._cfl3d_plain(u))
    u[1, S[0] // 2, S[1] // 2, S[2] // 2] = float("nan")
    assert bool(torch.isnan(sk.cfl3d(u)))


def _dir_mult_forms(d):
    """(first output, kernel call) of each of the six `pcg_dir_mult` forms
    the fused iteration launches (`check.variants`: beta from a smooth's
    words, or none, beta 0 with eps_prev = r at the seed; f32 and bf16
    directions, f32 operator and shadows) on inputs ``d``."""
    from waterlily_tpu_torch.kernels.check import variants
    return [(outs[0], kern) for outs, kern, _ in variants("pcg_dir_mult", d)]


def test_march_kernels_launch_once(device):
    """cfl3d and ana_mult3d, with and without the dot, every form of
    pcg_dir_mult, pcg_update and pcg_axpy, and mult3d and mult3d_stream
    with the dot (f32 operator and shadows) are one launch a call: the
    launch counter, and the profiler sees one kernel on the card and no
    PyTorch reduce (or scalar fill) beside it."""
    from waterlily_tpu_torch.kernels.check import inputs, words
    from waterlily_tpu_torch.ops import stencil_kernels as sk
    from waterlily_tpu_torch.ops import attic as at
    from waterlily_tpu_torch.utils.perf import device_profile
    d = inputs(FINE, 0, device)
    x, r, eps, z, iD, s = (d["x"], d["r"], d["eps"], d["z"], d["lev"].iD,
                           d["dt"])
    ws = words(None, device)
    calls = [(sk.cfl3d, lambda: sk.cfl3d(d["u"])),
             (sk.ana_mult3d, lambda: sk.ana_mult3d(x, 1.0, with_dot=True)),
             (sk.ana_mult3d, lambda: sk.ana_mult3d(x, 1.0)),
             (at.pcg_update, lambda: at.pcg_update(x, r, eps, z, iD, ws)),
             (at.pcg_axpy, lambda: at.pcg_axpy(x, r, eps, z, iD, s)),
             (at.mult3d_stream,
              lambda: at.mult3d_stream(d["lev"].L, d["lev"].D, x, True)),
             (at.mult3d_stream,
              lambda: at.mult3d_stream(d["L16"], d["D16"], x, True)),
             (sk.mult3d, lambda: sk.mult3d(d["lev"].L, d["lev"].D, x, True)),
             (sk.mult3d, lambda: sk.mult3d(d["L16"], d["D16"], x, True))]
    calls += [(at.pcg_dir_mult, call) for _, call in _dir_mult_forms(d)]
    for w, call in calls:
        n = w.launches
        ops = device_profile(call, 5)[1]
        assert w.launches == n + 5
        assert len(ops) == 1, ops


# the blocked levels pcg_dir_mult runs at on the 256³ sphere (the dense
# slice's FINE is checked above)
BLOCKED_LEVELS = [(258, 258, 258), (130, 130, 130), (66, 66, 66)]


@pytest.mark.parametrize("S", MARCH_RAGGED + BLOCKED_LEVELS)
def test_pcg_dir_mult_march_matches_plain(S, device):
    """The plane-marching pcg_dir_mult in all six forms where its column
    tiles and axis-0 chunks are cut raggedly, where axis 0 has one or two
    interior planes, and at the blocked levels: eps and z exact, the two
    sums within 1e-5 relative."""
    _check("pcg_dir_mult", S, device)


@pytest.mark.parametrize("S", [FINE, (3, 37, 70), (37, 29, 35)])
def test_pcg_iteration_sums_are_deterministic(S, device):
    """Two calls on one input give the same bits: eps, z and the words
    (its sum and the step taken from it) of every pcg_dir_mult form, the
    x, r and words of pcg_update and the x, r and rho of pcg_axpy (the
    last block sums the partials in index order; no atomics in the
    sums)."""
    from waterlily_tpu_torch.kernels.check import inputs, words
    from waterlily_tpu_torch.ops import attic as at
    d = inputs(S, 0, device)
    x, r, eps, z, iD, s = (d["x"], d["r"], d["eps"], d["z"], d["lev"].iD,
                           d["dt"])
    w = words(None, device)
    calls = _dir_mult_forms(d) + [
        ("pcg_update", lambda: at.pcg_update(x, r, eps, z, iD, w)),
        ("pcg_axpy", lambda: at.pcg_axpy(x, r, d["eps16"], z, d["iD16"],
                                         s))]
    for name, call in calls:
        one, two = call(), call()
        assert one[2].shape == (() if name == "pcg_axpy" else (at.WORDS,))
        for a, b in zip(one, two):
            assert torch.equal(a, b), name


@pytest.mark.parametrize("S", MARCH_RAGGED + BLOCKED_LEVELS)
def test_mult3d_stream_march_matches_plain(S, device):
    """The plane-marching mult3d_stream in all eight forms (f32 and bf16 L,
    f32 and bf16 x, with and without the dot) where its column tiles and
    axis-0 chunks are cut raggedly, where axis 0 has one or two interior
    planes, and at the blocked levels: z exact, the dot within 1e-5
    relative."""
    _check("mult3d_stream", S, device)


@pytest.mark.parametrize("S", [FINE, (3, 37, 70), (37, 29, 35)])
def test_mult3d_stream_dot_is_deterministic(S, device):
    """Two calls on one input give the same bits, z and the dot, in every
    form with the dot (the last block sums the partials in index order)."""
    from waterlily_tpu_torch.kernels.check import inputs, variants
    d = inputs(S, 0, device)
    for outs, kern, _ in variants("mult3d_stream", d):
        if len(outs) == 2:
            (z1, d1), (z2, d2) = kern(), kern()
            assert d1.shape == () and torch.equal(d1, d2), outs
            assert torch.equal(z1, z2), outs


@pytest.mark.parametrize("S", MARCH_RAGGED + BLOCKED_LEVELS)
def test_mult3d_march_matches_plain(S, device):
    """mult3d, the default path's operator, on the plane march in all
    eight forms (f32 and bf16 L, f32 and bf16 x, with and without the dot)
    where its column tiles and axis-0 chunks are cut raggedly, where axis 0
    has one or two interior planes, and at the blocked levels: z exact,
    the dot within 1e-5 relative."""
    _check("mult3d", S, device)


@pytest.mark.parametrize("S", [FINE, (3, 37, 70), (37, 29, 35),
                               (130, 130, 130)])
def test_mult3d_and_mult3d_stream_same_bits(S, device):
    """mult3d and mult3d_stream launch one kernel with one chunk rule: in
    every form the same z and dot bits (so also on a second call), each
    launch counted on its own wrapper."""
    from waterlily_tpu_torch.kernels.check import inputs, variants
    from waterlily_tpu_torch.ops import stencil_kernels as sk
    from waterlily_tpu_torch.ops import attic as at
    d = inputs(S, 0, device)
    forms = zip(variants("mult3d", d), variants("mult3d_stream", d))
    for (outs, halo, _), (outs_s, stream, _) in forms:
        assert outs == outs_s
        n = sk.mult3d.launches, at.mult3d_stream.launches
        one, two = halo(), stream()
        assert (sk.mult3d.launches, at.mult3d_stream.launches) == (
            n[0] + 1, n[1] + 1)
        one, two = ((one, two) if isinstance(one, tuple)
                    else ((one,), (two,)))
        for a, b in zip(one, two):
            assert torch.equal(a, b), outs


def test_callable_u_bc_on_the_card_vs_cpu(device):
    """A domain velocity that is a function of time with a component that
    is a number: a sphere at a blocked size (66x50x50 cells, bc3d and the
    other kernels launched) constructs and steps on the card, and its 3
    steps match 3 on the CPU from the same state: pois_n and dt."""
    from waterlily_tpu_torch import AutoBody, Simulation
    from waterlily_tpu_torch.convert import flow_to, levels_to
    from waterlily_tpu_torch.flow import mom_step
    from waterlily_tpu_torch.ops import stencil_kernels as sk
    radius, center = 6.0, 23.0
    body = AutoBody(lambda x, t: torch.sqrt(torch.sum((x - center) ** 2,
                                                      dim=0)) - radius)
    n = sk.bc3d.launches
    sim = Simulation((64, 48, 48), lambda i, t: t if i == 0 else 0.0,
                     2 * radius, U=1, nu=2 * radius / 100, body=body,
                     device=device)
    assert sk.use_blocked(sim.cfg.S, torch.float32, device)
    init, levels = sim.flow, sim.levels
    sim.steps(3, remeasure=False)
    assert sk.bc3d.launches > n
    cpu = torch.device("cpu")
    state, lv = flow_to(init, cpu), levels_to(levels, cpu)
    cfg = dataclasses.replace(sim.cfg, device=cpu)
    pois, dts = [], []
    for _ in range(3):
        state, aux = mom_step(cfg, lv, state)
        pois.append(aux["pois_n"])
        dts.append(float(aux["dt"]))
    assert sim.pois_n == pois
    assert all(abs(a - b) <= 1e-5 * abs(b) for a, b in zip(sim.dts[1:], dts))
    assert bool(torch.isfinite(sim.flow.u).all())


# the roll probe's row bands and warps cut raggedly: a short last band,
# warps across bands and planes, three-row and three-column planes
ROLL_RAGGED = [(5, 9, 13), (4, 258, 37), (3, 37, 70), (7, 3, 33),
               (5, 17, 3), (258, 258, 258)]


@pytest.mark.parametrize("S", ROLL_RAGGED)
def test_roll_probe_ragged(S, device):
    _check("roll_probe", S, device)


@pytest.mark.parametrize("form", ["f32", "bf16", "L16"])
def test_pcg_blocked_on_the_card_vs_cpu(form, device):
    """The fused-iteration smoother on the card against the same smooth on
    the CPU (plain forms) at the dense slice's fine level: f32 directions
    and operator shadows within 1e-5; bf16 directions on the mean
    difference (2e-6: the card's sums, in another order, can round a
    direction value to the neighbouring bf16 value at a few cells).  The
    CPU reference runs on one thread (its sums' order, and so the bf16
    roundings, depend on the thread count), the count restored after."""
    import dataclasses
    from waterlily_tpu_torch.kernels.check import inputs
    from waterlily_tpu_torch.ops import attic as at

    def level(dev):
        d = inputs(FINE, 0, dev)
        lev = dataclasses.replace(d["lev"], blocked=True,
                                  bf16_eps=form == "bf16")
        if form == "L16":
            lev = dataclasses.replace(lev, L16=d["L16"], D16=d["D16"],
                                      iD16=d["iD16"])
        return lev, d["r"]

    (lc, rc), (lg, rg) = level(torch.device("cpu")), level(device)
    n = at.pcg_dir_mult.launches
    xg, rg = at.pcg_blocked(lg, torch.zeros_like(rg), rg)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        xc, rc = at.pcg_blocked(lc, torch.zeros_like(rc), rc)
    finally:
        torch.set_num_threads(threads)
    assert at.pcg_dir_mult.launches == n + 6
    for g, c in ((xg, xc), (rg, rc)):
        diff = (g.cpu() - c).abs()
        if form == "bf16":
            assert float(diff.mean()) <= 2e-6, float(diff.mean())
        else:
            assert float(diff.max()) <= 1e-5, float(diff.max())


def _blocked_level(form, device):
    """The dense slice's fine level, blocked, with f32 or bf16 directions
    or the operator shadows, and its residual and x (`check.inputs`)."""
    from waterlily_tpu_torch.kernels.check import inputs
    d = inputs(FINE, 0, device)
    lev = dataclasses.replace(d["lev"], blocked=True,
                              bf16_eps=form == "bf16")
    if form == "L16":
        lev = dataclasses.replace(lev, L16=d["L16"], D16=d["D16"],
                                  iD16=d["iD16"])
    return lev, d["r"], d["x"]


@pytest.mark.parametrize("form", ["f32", "bf16", "L16"])
@pytest.mark.parametrize("case", sorted(FOLD_CASES))
def test_pcg_blocked_folds_the_scalar_step(case, form, device):
    """The smooth with the PCG's scalar step inside its two sweeps (the
    smooth's device words) equals, bit for bit, `pcg_blocked` with the
    step in 0-d tensors between them (`_pcg_chain.chain`), in each early
    exit (rho 0 at the seed, denom 0, alpha outside [1e-2, 1e2], rho2
    under 10 eps; each trips in the chain) and in a smooth that runs on,
    with f32 and bf16 directions and the operator shadows: 6 launches of
    each sweep."""
    from waterlily_tpu_torch.ops import attic as at
    lev, r, x = _blocked_level(form, device)
    lev, r, exit_ = fold_case(case, lev, r)
    exits = []
    want = chain(lev, x, r, exits=exits)
    n = at.pcg_dir_mult.launches, at.pcg_update.launches
    got = at.pcg_blocked(lev, x, r)
    assert (at.pcg_dir_mult.launches - n[0],
            at.pcg_update.launches - n[1]) == (6, 6)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert exits[:1] == ([exit_] if exit_ else []), exits


@pytest.mark.parametrize("bound", [1e-2, 1e2])
def test_scalar_step_at_the_alpha_bounds(bound, device):
    """`pcg_dir_mult`'s step keeps a step of exactly the f32 bound alive
    and kills one an ulp outside it, as torch compares an f32 tensor with
    the Python number, its words bit for bit those of the plain step
    (`attic._alpha_step`) on the same sums."""
    import numpy as np
    from waterlily_tpu_torch.kernels.check import inputs, words
    from waterlily_tpu_torch.ops import attic as at
    d = inputs(FINE, 0, device)
    lev, eps, r = d["lev"], d["eps"], d["r"]
    w0 = words(None, device)
    # this sweep's <z, eps> (its own sum in its words), on the same beta
    den = at.pcg_dir_mult(lev.L, lev.D, eps, r, lev.iD, w0)[2][at.W_SUM]
    den32, b = np.float32(float(den)), np.float32(bound)
    away = np.float32(np.inf) * np.sign(den32)   # rho has den's sign
    rho = np.float32(np.float64(b) * np.float64(den32))
    while rho / den32 != b:         # the f32 step exactly at the bound
        rho = np.nextafter(rho, away if rho / den32 < b else np.float32(0))
    out = rho
    while out / den32 == b:         # the next one outside it
        out = np.nextafter(out, np.float32(0) if bound < 1 else away)
    for value, dead in ((rho, 0.0), (out, 1.0)):
        w = w0.clone()
        w[at.W_RHO], w[at.W_DEAD] = float(value), 0.0
        got = at.pcg_dir_mult(lev.L, lev.D, eps, r, lev.iD, w)[2]
        want = at._alpha_step(w, den, None)
        assert torch.equal(got, want), (got, want)
        assert float(got[at.W_DEAD]) == dead, (bound, value, got)


@pytest.mark.parametrize("form", ["f32", "bf16", "L16"])
def test_pcg_blocked_members_fold_the_step(form, device):
    """Under `torch.func.vmap` (3 members: one that runs on, one with a
    zero residual, one scaled to trip rho2) the folded smooth equals
    `vmap` of the 0-d-tensor chain (the sweeps' member forms, the step one
    value a member) bit for bit, in 12 member-form launches."""
    from waterlily_tpu_torch.ops import attic as at
    lev, r, x = _blocked_level(form, device)
    r2 = fold_case("rho2", lev, r)[1]
    R = torch.stack([r, torch.zeros_like(r), r2])
    X = torch.stack([x, x, x])
    want = torch.func.vmap(lambda x, r: chain(lev, x, r))(X, R)
    n = at.pcg_dir_mult.members + at.pcg_update.members
    got = torch.func.vmap(lambda x, r: at.pcg_blocked(lev, x, r))(X, R)
    assert at.pcg_dir_mult.members + at.pcg_update.members - n == 12
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("S", [(386, 386, 386), (50, 50, 50)])
def test_pcg_blocked_is_its_sweeps_alone(S, device):
    """A smooth of a blocked level (the 384³ sphere's finest and coarsest
    blocked shapes) makes 2·it runtime launches, the seed's sweep, ``it``
    updates and ``it − 1`` rebuilds, and puts no other operation on the
    card: no copy, no fill, no ATen kernel (profiler)."""
    from torch.profiler import ProfilerActivity, profile
    from waterlily_tpu_torch.grid import mask_interior
    from waterlily_tpu_torch.ops import attic as at
    from waterlily_tpu_torch.ops import poisson as tp
    g = torch.Generator(device=device).manual_seed(0)
    lev = tp.make_level(torch.rand((3,) + S, generator=g, device=device)
                        + 0.5)
    assert lev.blocked
    r = mask_interior(torch.rand(S, generator=g, device=device) - 0.5)
    x = torch.zeros_like(r)
    at.pcg_blocked(lev, x, r)       # the library and its queries, once
    launch = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cuGraphLaunch")
    for _ in range(3):              # a session may record nothing
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            at.pcg_blocked(lev, x, r, it=6)
            torch.cuda.synchronize()
        evs = prof.events()
        launches = [e.name for e in evs if e.name.startswith(launch)]
        if launches:
            break
    copies = [e.name for e in evs
              if e.name.startswith(("cudaMemcpy", "cudaMemset", "cuMemcpy",
                                    "cuMemset"))]
    on_card = {e.name for e in evs
               if e.device_type == torch.autograd.DeviceType.CUDA}
    assert len(launches) == 12, launches
    assert not copies, copies
    assert on_card and all("dir_mult_kernel" in k or "axpy_rho_kernel" in k
                           for k in on_card), on_card


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("M", [1, 3, 32])
@pytest.mark.parametrize("S", [(194, 130), (98, 66), (50, 34)])
def test_pcg_members_match_plain(S, M, shared, device):
    """pcg_fused's member form (`pcg_members`, and `pcg_fused` under
    `torch.func.vmap`) against `vmap` of the plain version: the grid form
    in member chunks, the one-block form, an operator shared and one a
    member, member 1's zero residual exactly; one launch a chunk."""
    from waterlily_tpu_torch.kernels.check import compare_members
    rows = compare_members(S, M, shared, 1, device)
    bad = [r for r in rows if not r["ok"]]
    assert not bad, bad


@pytest.mark.parametrize("S", [(194, 130), (98, 66)])
def test_pcg_members_nested_vmap(S, device):
    """`pcg_fused` under `vmap` of `vmap` (2 × 3 members, an operator a
    member) on the card: the rules fold both levels into one member axis,
    the kernel launches once for each member chunk of all six, and each
    member agrees with its own plain `pcg` within 1e-5."""
    from waterlily_tpu_torch.kernels.check import member_inputs
    from waterlily_tpu_torch.ops import pcg_kernel as pk
    from waterlily_tpu_torch.ops.poisson import PoissonLevel, pcg
    d = member_inputs(S, 6, False, 1, device)
    grid = lambda t: t.reshape((2, 3) + tuple(t.shape[1:]))
    fn = lambda L, Dd, iD, x, r: pk.pcg_fused(
        PoissonLevel(L=L, D=Dd, iD=iD), x, r)
    n = pk.pcg_fused.launches
    x, r = torch.func.vmap(torch.func.vmap(fn))(
        *(grid(d[f]) for f in ("L", "D", "iD", "x", "r")))
    assert pk.pcg_fused.launches - n == pk.launch_chunks(S, 6, device)
    for m, lev in enumerate(d["levels"]):
        own = pcg(lev, d["x"][m], d["r"][m])
        for got, want in zip((x, r), own):
            err = float((got[m // 3, m % 3] - want).abs().max())
            assert err <= 1e-5, (m, err)


def test_pcg_members_refuse(device):
    """The member form raises on a field it does not take (f64, a D
    without iD's member axis) and never runs the plain version on the
    card."""
    from waterlily_tpu_torch.kernels.check import member_inputs
    from waterlily_tpu_torch.ops import pcg_kernel as pk
    d = member_inputs((50, 34), 3, False, 0, device)
    with pytest.raises(TypeError):
        pk.pcg_members(d["L"].double(), d["D"].double(), d["iD"].double(),
                       d["x"].double(), d["r"].double())
    with pytest.raises(ValueError):
        pk.pcg_members(d["L"], d["D"], d["iD"][0], d["x"], d["r"])
    # a cooperative grid one member wider than the card holds at once: the
    # launch itself refuses it (cudaErrorCooperativeLaunchTooLarge, 720)
    from waterlily_tpu_torch.kernels.build import launch
    S = (194, 130)
    N, dev = S[0] * S[1], torch.device(device).index or 0
    blocks, k = pk._launch_grid(N, dev, 2)
    M = pk._coresident(dev, 2, k) // blocks + 1
    g = member_inputs(S, M, False, 0, device)
    work = torch.empty(2 * M * (N + blocks), dtype=torch.float32,
                       device=device)
    with pytest.raises(RuntimeError, match="CUDA error 720"):
        launch("wl_pcg", g["L"], g["D"], g["iD"], g["x"], g["r"], work, 2,
               *S, 1, 6, 0, blocks, k, M, N * 2, N)
    # and leaves no error behind for the next launch to report
    x, _r = pk.pcg_members(d["L"], d["D"], d["iD"], d["x"], d["r"])
    torch.cuda.synchronize()
    assert bool(torch.isfinite(x).all())


# --- the seven 3D stencils' member forms (a 3D ensemble under vmap) ---------

@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("M", [1, 3, 8])
@pytest.mark.parametrize("S", [FINE, RAGGED])
@pytest.mark.parametrize("name", STENCILS)
def test_stencil_members_match_single_launches(name, S, M, shared, device):
    """Each stencil's member form (`torch.func.vmap` of its wrapper: one
    launch for every member) equals each member's own launch bit for bit
    (sums included: a member's reduction is its own launch's) and `vmap`
    of the plain version within the kernel's tolerance, in every form of
    `check.stencil_member_variants` (the operator, dt, ν and BC values
    shared, or one a member; `bc3d` in place, seen in the batched field)."""
    from waterlily_tpu_torch.kernels.check import compare_stencil_members
    rows = compare_stencil_members(name, S, M, shared, 1, device)
    bad = [r for r in rows if not r["ok"]]
    assert not bad, bad
    assert all(r["single_err"] == 0 and r["launches"] == 1 for r in rows)


# --- ana_mult3d's member form (a banded ensemble's far-field operator) -----

@pytest.mark.parametrize("M", [1, 3, 8])
@pytest.mark.parametrize("S", [FINE, (50, 34, 34)])
def test_ana_mult3d_members_match_single_launches(S, M, device):
    """`ana_mult3d`'s member form (one launch for every member, with and
    without the dot, walls and every periodic mask) equals each member's
    own launch bit for bit and `vmap` of the plain version within the
    kernel's tolerance (z exact, the dot 1e-5)."""
    from waterlily_tpu_torch.kernels.check import compare_stencil_members
    rows = compare_stencil_members("ana_mult3d", S, M, False, 1, device)
    bad = [r for r in rows if not r["ok"]]
    assert not bad, bad
    assert all(r["single_err"] == 0 and r["launches"] == 1 for r in rows)


@pytest.mark.parametrize("with_dot", [False, True])
def test_ana_mult3d_members_vs_cpu(with_dot, device):
    """The member form on the card against the CPU's (`vmap` of the plain
    version) on the same inputs: z bit for bit, each member's dot within
    1e-5 relative."""
    from waterlily_tpu_torch.ops import stencil_kernels as sk
    g = torch.Generator().manual_seed(7)
    x = torch.randn((3,) + FINE, generator=g)
    run = lambda x: torch.func.vmap(
        lambda v: sk.ana_mult3d(v, 2.0, (1,), with_dot))(x)
    n = sk.ana_mult3d.members
    card, cpu = run(x.to(device)), run(x)
    assert sk.ana_mult3d.members - n == 1
    if with_dot:
        assert torch.equal(card[0].cpu(), cpu[0])
        assert torch.allclose(card[1].cpu(), cpu[1], rtol=1e-5, atol=0)
    else:
        assert torch.equal(card.cpu(), cpu)


@pytest.mark.parametrize("S", MARCH_RAGGED)
@pytest.mark.parametrize("name", ["mult3d", "cfl3d", "ana_mult3d"])
def test_march_members_ragged(name, S, device):
    """The marches' member forms where column tiles and axis-0 chunks are
    cut raggedly and where axis 0 has one or two interior planes: every
    member's chunks and sums are its own launch's (3 members, an operator
    a member)."""
    from waterlily_tpu_torch.kernels.check import compare_stencil_members
    rows = compare_stencil_members(name, S, 3, False, 1, device)
    bad = [r for r in rows if not r["ok"] or r["single_err"] != 0]
    assert not bad, bad


@pytest.mark.parametrize("name", ["mult3d", "bc3d", "conv_diff3d"])
def test_stencil_members_nested_vmap(name, device):
    """`vmap` of `vmap` (2 × 3 members) through a stencil wrapper: the
    rules fold both levels into one member axis and the kernel launches
    once for all six, each member equal to its own launch (`bc3d` filled
    in place in the batched field)."""
    from waterlily_tpu_torch.kernels.check import (
        stencil_member_inputs, stencil_member_variants, member_args)
    from waterlily_tpu_torch.ops import stencil_kernels as sk
    d = stencil_member_inputs(FINE, 6, False, 1, device)
    outputs, fn, _plain, args, dims = stencil_member_variants(name, d)[0]
    grid = lambda a, dd: (a.reshape((2, 3) + tuple(a.shape[1:]))
                          if dd == 0 else a)
    nested = [grid(a, dd) for a, dd in zip(member_args(args), dims)]
    wrapper = sk.kernel_wrappers()[name]
    n = wrapper.launches
    out = torch.func.vmap(torch.func.vmap(fn, in_dims=dims),
                          in_dims=dims)(*nested)
    assert wrapper.launches - n == 1
    out = out if isinstance(out, tuple) else (out,)
    own_args = member_args(args)
    for m in range(6):
        own = fn(*[a[m] if dd == 0 else a for a, dd in zip(own_args, dims)])
        own = own if isinstance(own, tuple) else (own,)
        for got, want in zip(out, own):
            assert torch.equal(got[m // 3, m % 3], want), (name, m)
        if name == "bc3d":
            assert torch.equal(nested[0][m // 3, m % 3], own[0])


# --- the blocked-level PCG seams' member forms (vmap under KDOT, KAXPY,
# PCG_BLOCKED, STREAM) -------------------------------------------------------

SEAM_MEMBERS = ["dot3d", "pcg_axpy", "pcg_dir_mult", "pcg_update",
                "mult3d_stream", "increment3d_stream"]


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("M", [1, 3, 8])
@pytest.mark.parametrize("S", [FINE, RAGGED])
@pytest.mark.parametrize("name", SEAM_MEMBERS + ["pcg_blocked"])
def test_seam_members_match_single_launches(name, S, M, shared, device):
    """Each PCG-seam wrapper's member form (`torch.func.vmap` of it: one
    launch for every member) equals each member's own launch bit for bit
    (its dots included) and `vmap` of the plain version within the
    kernel's tolerance, in every form of `check.stencil_member_variants`
    (the operator and β, upd shared or one a member; bf16 directions,
    operator shadows); `pcg_blocked` under `vmap` 12 launches a smooth,
    each member bit for bit its own smooth."""
    from waterlily_tpu_torch.kernels.check import compare_stencil_members
    rows = compare_stencil_members(name, S, M, shared, 1, device)
    bad = [r for r in rows if not r["ok"] or r["single_err"] != 0]
    assert not bad, bad


@pytest.mark.parametrize("S", MARCH_RAGGED)
@pytest.mark.parametrize("name", ["pcg_dir_mult", "mult3d_stream"])
def test_seam_march_members_ragged(name, S, device):
    """The marching seam kernels' member forms where column tiles and
    axis-0 chunks are cut raggedly and where axis 0 has one or two
    interior planes (3 members, an operator a member)."""
    from waterlily_tpu_torch.kernels.check import compare_stencil_members
    rows = compare_stencil_members(name, S, 3, False, 1, device)
    bad = [r for r in rows if not r["ok"] or r["single_err"] != 0]
    assert not bad, bad


@pytest.mark.parametrize("name", SEAM_MEMBERS)
def test_seam_members_nested_vmap(name, device):
    """`vmap` of `vmap` (2 × 3 members) through each PCG-seam wrapper: one
    launch for all six, each member equal to its own launch."""
    from waterlily_tpu_torch.kernels.check import (
        stencil_member_inputs, stencil_member_variants, member_args)
    from waterlily_tpu_torch.ops import stencil_kernels as sk
    d = stencil_member_inputs(FINE, 6, False, 1, device)
    _outputs, fn, _plain, args, dims = stencil_member_variants(name, d)[0]
    grid = lambda a, dd: (a.reshape((2, 3) + tuple(a.shape[1:]))
                          if dd == 0 else a)
    nested = [grid(a, dd) for a, dd in zip(member_args(args), dims)]
    wrapper = sk.kernel_wrappers()[name]
    n, nm = wrapper.launches, wrapper.members
    out = torch.func.vmap(torch.func.vmap(fn, in_dims=dims),
                          in_dims=dims)(*nested)
    assert wrapper.launches - n == 1 and wrapper.members - nm == 1
    out = out if isinstance(out, tuple) else (out,)
    for m in range(6):
        own = fn(*[a[m] if dd == 0 else a for a, dd in zip(args, dims)])
        own = own if isinstance(own, tuple) else (own,)
        for got, want in zip(out, own):
            assert torch.equal(got[m // 3, m % 3], want), (name, m)


def test_seam_members_refuse(device):
    """A member form raises on operands its kernel does not take (an
    operand with another member count, f64) and never runs the plain
    version on the card."""
    from waterlily_tpu_torch.kernels.check import stencil_member_inputs
    from waterlily_tpu_torch.ops import attic as at
    d = stencil_member_inputs(FINE, 3, False, 1, device)
    with pytest.raises(ValueError):
        torch.func.vmap(lambda a, b: at.dot3d(a, b, "ab"))(
            d["r"], d["x"][:, :-1].contiguous())
    with pytest.raises(TypeError):
        torch.func.vmap(lambda x, r: at.pcg_update(
            x, r, x, r, r, torch.zeros(at.WORDS, device=device)))(
                d["x"].double(), d["r"].double())
