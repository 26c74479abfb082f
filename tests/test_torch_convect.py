"""Port parity: convection-diffusion (torch vs JAX, and the conv kernel's
plain version vs the Pallas kernel in interpret mode)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waterlily_tpu.ops import convect as jc
from waterlily_tpu.ops.bc import bc_vector as jbc_vector
from waterlily_tpu.ops.pallas_stencil import conv_diff3d_pallas
from waterlily_tpu_torch.ops import convect as tc
from waterlily_tpu_torch.ops import stencil_kernels as sk

from _torch_parity import (F32, F64, STENCIL_RTOL, normal, tt, jj,
                           assert_exact, assert_rel)

S3 = (14, 12, 10)
LIMITERS = {"quick": (jc.quick, tc.quick), "vanleer": (jc.vanleer, tc.vanleer)}


@pytest.mark.parametrize("name", ["quick", "vanleer"])
def test_limiters(name):
    jl, tl = LIMITERS[name]
    u, c, d = (normal(s, (400,)) for s in (1, 2, 3))
    d[:20] = u[:20]   # exercise the van Leer division guard
    assert_exact(tl(tt(u), tt(c), tt(d)), jl(jj(u), jj(c), jj(d)))
    assert_exact(tc.median3(tt(u), tt(c), tt(d)),
                 jc.median3(jj(u), jj(c), jj(d)))


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("name", ["quick", "vanleer"])
def test_conv_diff_vs_jax(dtype, name):
    jl, tl = LIMITERS[name]
    u = normal(4, (3,) + S3, dtype)
    rj = jc.conv_diff(jj(u), 0.05, (), jl)
    rt = tc.conv_diff(tt(u), 0.05, (), tl)
    assert_rel(rt, rj, STENCIL_RTOL[dtype])
    # cells the reference never writes (index 0 on any axis) are exactly
    # zero; the top ghost planes are written by the transverse sweeps
    for ax in (1, 2, 3):
        assert bool((rt.select(ax, 0) == 0).all())
    assert bool((rt[0, -1] != 0).any())


@pytest.mark.parametrize("S", [(14, 12, 10), (18, 14, 18)])
@pytest.mark.parametrize("name", ["quick", "vanleer"])
def test_conv_diff3d_plain_vs_pallas(S, name):
    """The kernel's plain version against the Pallas conv kernel (merged
    all-component form, interpret mode); the Pallas kernel accumulates its
    sweeps in another order, hence a relative tolerance."""
    jl, tl = LIMITERS[name]
    u = normal(5, (3,) + S)
    rj = conv_diff3d_pallas(jj(u), 0.05, jl, S, interpret=True)
    rt = sk.conv_diff3d(tt(u), 0.05, tl)
    assert_rel(rt, rj, 1e-6)


@pytest.mark.parametrize("perdir", [(0,), (1,), (0, 2)])
def test_conv_core_periodic(perdir):
    """Periodic flux variants (ϕuP wrap, top-face copy) of the plain form."""
    u = normal(6, (3,) + S3)
    u = np.asarray(jbc_vector(jj(u), (0.0, 0.0, 0.0), False, perdir))
    rj = jc.conv_diff(jj(u), 0.05, perdir, jc.quick)
    rt = tc.conv_diff(tt(u), 0.05, perdir, tc.quick)
    assert_rel(rt, rj, 1e-6)


def test_accelerate():
    r = normal(7, (3,) + S3)
    g = lambda i, t: 0.1 * (i + 1) * t
    Uj = lambda i, t: jnp.sin(t) * (i == 0)
    Ut = lambda i, t: torch.sin(t) * (i == 0)
    aj = jc.accelerate(jj(r), jnp.float32(0.3), g, Uj, jnp.float32)
    at = tc.accelerate(tt(r), 0.3, g, Ut, torch.float32)
    assert_rel(at, aj, 1e-6)
    assert tc.accelerate(tt(r), 0.3, None, (1.0, 0.0, 0.0),
                         torch.float32) is not None


def _minmod_jax(u, c, d):
    """A user-defined limiter (minmod-limited linear upwind), jnp ops."""
    a, b = c - u, d - c
    return c + 0.5 * jnp.where(a * b > 0, jnp.sign(a)
                               * jnp.minimum(jnp.abs(a), jnp.abs(b)), 0.0)


def _minmod_torch(u, c, d):
    """The same limiter, torch ops."""
    a, b = c - u, d - c
    return c + 0.5 * torch.where(a * b > 0, torch.sign(a)
                                 * torch.minimum(torch.abs(a), torch.abs(b)),
                                 0.0)


def _spy_kernel_gate(monkeypatch):
    """The kernel gate forced on for CPU tensors and `sk.conv_diff3d`
    wrapped to record its calls (it runs its plain version here); returns
    the calls and the wrapper itself."""
    calls = []
    conv3d = sk.conv_diff3d
    monkeypatch.setattr(sk, "use_blocked", lambda S, dtype, device: True)

    def spy(*args, **kw):
        calls.append(args[2])
        return conv3d(*args, **kw)

    monkeypatch.setattr(sk, "conv_diff3d", spy)
    return calls, conv3d


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("perdir", [(), (0, 2)])
def test_user_limiter_runs_plain_form(dtype, perdir, monkeypatch):
    """Where the kernel gate is open a user-defined limiter goes to
    `sk.conv_diff3d` like the compiled-in ones (the kernel traces it in on
    the card; on the CPU the wrapper runs its plain form, with no launch)
    and matches JAX's conv_diff with the same limiter (STENCIL_RTOL: the
    same slice form in both packages).  It is not compiled into the kernel
    library: the wrapper builds it from `kernels.limiter`."""
    calls, kernel = _spy_kernel_gate(monkeypatch)
    launches = kernel.launches
    u = normal(8, (3,) + S3, dtype)
    if perdir:
        u = np.asarray(jbc_vector(jj(u), (0.0, 0.0, 0.0), False, perdir))
    rj = jc.conv_diff(jj(u), 0.05, perdir, _minmod_jax)
    rt = tc.conv_diff(tt(u), 0.05, perdir, _minmod_torch)
    assert calls == [_minmod_torch] and kernel.launches == launches
    assert rt.dtype == tt(u).dtype
    assert_rel(rt, rj, STENCIL_RTOL[dtype])
    with pytest.raises(NotImplementedError):
        sk._limiter_code(_minmod_torch)


def _clamped(u, c, d):
    """A user-defined limiter with a clamp, divisions by a number and of a
    number, logical operators and tensor constants."""
    t = (c - u).clamp(min=-0.5, max=0.5) / 3.0 + 2.0 / (d * d + 1)
    m = ~((u > c) & (c < d)) | (u == d)
    return (torch.where(m, t, torch.full_like(c, 0.25))
            - torch.zeros_like(u) * m)


def _clamped_cuda_form(u, c, d):
    """`_clamped` as PyTorch computes it on a CUDA tensor: ``t / 3.0`` is
    ``t`` times the f32 reciprocal of 3, ``2.0 / t`` is ``2 * (1 / t)``."""
    three = torch.tensor(np.float32(1) / np.float32(3))
    t = (c - u).clamp(min=-0.5, max=0.5) * three + 2.0 * (1.0 / (d * d + 1))
    m = ~((u > c) & (c < d)) | (u == d)
    return (torch.where(m, t, torch.full_like(c, 0.25))
            - torch.zeros_like(u) * m)


@pytest.mark.parametrize("name", ["minmod", "quick", "vanleer", "clamped"])
def test_limiter_lowering_matches_the_limiter(name):
    """`kernels.limiter.lower` traces a limiter into the straight-line
    program the conv kernel is built with; the program, run with the
    kernel's order and rounding (`evaluate`), equals the limiter exactly
    on inputs with equal and NaN taps, and renders to C with one
    statement per operation."""
    from waterlily_tpu_torch.kernels import limiter as lim
    fn, want = {"minmod": (_minmod_torch, _minmod_torch),
                "quick": (tc.quick, tc.quick),
                "vanleer": (tc.vanleer, tc.vanleer),
                "clamped": (_clamped, _clamped_cuda_form)}[name]
    u, c, d = (tt(normal(s, (4000,))) for s in (11, 12, 13))
    d[:40], c[40:80], u[80:90] = u[:40], u[40:80], float("nan")
    prog = lim.lower(fn)
    got, ref = lim.evaluate(prog, u, c, d), want(u, c, d)
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    ok = ~torch.isnan(ref)
    assert torch.equal(got[ok], ref[ok])
    src = lim.source(prog)
    assert src.count("    const ") == len(prog.ops) - 3
    assert f"int {lim.ENTRY}(" in src and "launch_conv<UserLimiter>" in src


@pytest.mark.parametrize("case", ["exp", "control_flow", "reduction",
                                  "bool_result", "f64_constant", "alpha"])
def test_limiter_lowering_refuses(case):
    """A limiter with no kernel form raises NotImplementedError: an
    operation outside the set, control flow on tensor values, a reduction,
    a result that is not an f32 field, a constant field of another dtype,
    a keyword that changes the arithmetic."""
    from waterlily_tpu_torch.kernels import limiter as lim
    fn = {"exp": lambda u, c, d: c + torch.exp(d - c),
          "control_flow": lambda u, c, d: c if bool((c > u).all()) else d,
          "reduction": lambda u, c, d: c + torch.max(d),
          "bool_result": lambda u, c, d: c > d,
          "f64_constant": lambda u, c, d: c * torch.full_like(
              c, 0.5, dtype=torch.float64),
          "alpha": lambda u, c, d: torch.add(c, d, alpha=0.5)}[case]
    with pytest.raises(NotImplementedError):
        lim.lower(fn)


@pytest.mark.parametrize("name", ["quick", "vanleer"])
def test_kernel_limiters_take_the_kernel(name, monkeypatch):
    """Under the same open gate QUICK and van Leer still go to
    `sk.conv_diff3d` (whose plain version runs on the CPU)."""
    calls, _ = _spy_kernel_gate(monkeypatch)
    jl, tl = LIMITERS[name]
    u = normal(9, (3,) + S3)
    rt = tc.conv_diff(tt(u), 0.05, (), tl)
    assert calls == [tl]
    assert_rel(rt, jc.conv_diff(jj(u), 0.05, (), jl), STENCIL_RTOL[F32])


def test_conv_diff3d_limiter_codes():
    assert sk._limiter_code(tc.quick) == 0
    assert sk._limiter_code(tc.vanleer) == 1
    with pytest.raises(NotImplementedError):
        sk._limiter_code(lambda u, c, d: c)
