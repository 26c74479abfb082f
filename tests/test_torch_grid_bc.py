"""Port parity: grid helpers and boundary conditions (torch vs JAX)."""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waterlily_tpu import grid as jgrid
from waterlily_tpu.ops import bc as jbc
from waterlily_tpu.ops.pallas_stencil import bc3d_pallas
from waterlily_tpu_torch import grid as tgrid
from waterlily_tpu_torch.ops import bc as tbc
from waterlily_tpu_torch.ops import stencil_kernels as sk

from _torch_parity import (F32, F64, TORCH, JAX, normal, tt, jj, npy,
                           assert_exact, assert_rel)

S3 = (14, 12, 10)


@pytest.mark.parametrize("S", [(14, 12, 10), (9, 7)])
def test_interior_mask_and_pad(S):
    assert_exact(tgrid.interior_mask(S), jgrid.interior_mask(S))
    a = normal(0, tuple(s - 2 for s in S))
    assert_exact(tgrid.pad_interior(tt(a)), jgrid.pad_interior(jj(a)))
    v = normal(1, (3,) + tuple(s - 2 for s in S))
    assert_exact(tgrid.pad_interior(tt(v), lead=1),
                 jgrid.pad_interior(jj(v), lead=1))
    f = normal(2, (2,) + S)
    assert_exact(tgrid.mask_interior(tt(f), len(S)),
                 jgrid.mask_interior(jj(f), len(S)))
    assert tgrid.inside_count(S) == jgrid.inside_count(S)


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("i", [None, 0, 1, 2])
def test_loc_grid(dtype, i):
    assert_exact(tgrid.loc_grid(S3, i, TORCH[dtype]),
                 jgrid.loc_grid(S3, i, JAX[dtype]))


def test_interior_views_and_norms():
    a = normal(3, S3, F64)
    for off in [None, (1, 0, 0), (0, -1, 0), (0, 0, 1)]:
        assert_exact(tgrid.interior_view(tt(a), 3, off),
                     jgrid.interior_view(jj(a), 3, off))
    for ax in range(3):
        for off in (-1, 1):
            assert_exact(tgrid.shift(tt(a), ax, off), jgrid.shift(jj(a), ax, off))
    assert_rel(tgrid.l2(tt(a)), jgrid.l2(jj(a)), 1e-12)
    assert_exact(tgrid.linf(tt(a)), jgrid.linf(jj(a)))
    b = normal(4, S3, F64)
    assert_rel(tgrid.field_dot(tt(a), tt(b)), jgrid.field_dot(jj(a), jj(b)),
               1e-12)


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("S", [(14, 12, 10), (9, 7)])
def test_plane_and_set_interior(dtype, S):
    D = len(S)
    for axis in range(D):
        for idx in (0, 1, -1):
            assert tgrid.plane(D, axis, idx) == jgrid.plane(D, axis, idx)
    a = normal(5, (D,) + S, dtype)
    v = normal(6, (D,) + tuple(s - 2 for s in S), dtype)
    ta = tt(a)
    assert_exact(tgrid.set_interior(ta, D, tt(v)),
                 jgrid.set_interior(jj(a), D, jj(v)))
    assert_exact(ta, a)                      # the input is left as it was
    assert_exact(tgrid.set_interior(tt(a[0]), D, 2.5),
                 jgrid.set_interior(jj(a[0]), D, 2.5))


def test_interp():
    """The reference's oracle (maintests.jl:58-64, the JAX test's
    coordinates), on the port and against JAX."""
    a = tgrid.apply_field(lambda i, x: x[i] + 1.5, (2, 5, 5), torch.float32,
                          vector=True)
    b = tgrid.apply_field(lambda x: x[0] + 1.5, (5, 5), torch.float32)
    ja = jgrid.apply_field(lambda i, x: x[i] + 1.5, (2, 5, 5), jnp.float32,
                           vector=True)
    jb_ = jgrid.apply_field(lambda x: x[0] + 1.5, (5, 5), jnp.float32)
    for x, va, vb in (([1.0, -0.5], [2.5, 1.0], 2.5),
                      ([2.0, 1.5], [3.5, 3.0], 3.5)):
        xt = torch.tensor(x)
        np.testing.assert_allclose(npy(tgrid.interp(xt, a, vector=True)), va)
        np.testing.assert_allclose(float(tgrid.interp(xt, b)), vb)
        assert_exact(tgrid.interp(xt, a, vector=True),
                     jgrid.interp(jnp.asarray(x, jnp.float32), ja,
                                  vector=True))
        assert_exact(tgrid.interp(xt, b),
                     jgrid.interp(jnp.asarray(x, jnp.float32), jb_))


def _edge_points(S, dtype, n=60):
    """Points inside the padded grid, below index 0 (down to -1.5 cells
    past the low edge, where JAX wraps) and past the end (where it
    clamps), every axis mixed."""
    rng = np.random.default_rng(len(S))
    lo, hi = -2.0, np.array(S, float) + 1.0
    inside = rng.uniform(0.0, np.array(S, float) - 2.0, (n, len(S)))
    below = rng.uniform(lo, 0.0, (n, len(S)))
    past = rng.uniform(np.array(S, float) - 1.5, hi, (n, len(S)))
    mixed = np.where(rng.uniform(size=(n, len(S))) < 0.5, below, past)
    return np.concatenate([inside, below, past, mixed]).astype(dtype)


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("S", [(9, 7), (8, 7, 6)])
def test_interp_edges(dtype, S):
    """Batched `interp` against JAX's point-wise one (vmapped) at both
    edges: a corner index below 0 wraps once by the axis length, one past
    the end clamps (JAX's gather), never reaching past the tensor.  Exact
    in f64, 1e-6 relative in f32."""
    D = len(S)
    x = _edge_points(S, dtype)
    f = normal(7, S, dtype)
    v = normal(8, (D,) + S, dtype)
    rtol = 1e-6 if dtype is F32 else 0.0
    ref = jax.vmap(lambda p: jgrid.interp(p, jj(f)))(jj(x))
    refv = jax.vmap(lambda p: jgrid.interp(p, jj(v), vector=True))(jj(x))
    got = tgrid.interp(tt(x), tt(f))
    gotv = tgrid.interp(tt(x), tt(v), vector=True)
    assert got.shape == (x.shape[0],) and gotv.shape == x.shape
    assert_rel(got, ref, rtol)
    assert_rel(gotv, refv, rtol)
    # the low edge wraps: index -1 reads the last plane of axis 0
    p = np.zeros((1, D), dtype)
    p[0, 0] = -1.5                           # cell-centre index -1
    p[0, 1:] = 1.5
    want = f[(-1,) + (2,) * (D - 1)]
    np.testing.assert_array_equal(npy(tgrid.interp(tt(p), tt(f))), [want])
    # the high edge clamps: past the end reads the last plane only
    p[0, 0] = S[0] + 0.3
    want = f[(S[0] - 1,) + (2,) * (D - 1)]
    np.testing.assert_array_equal(npy(tgrid.interp(tt(p), tt(f))), [want])


def test_apply_field():
    f = lambda i, x: x[0] * (i + 1) - 0.5 * x[2]
    ft = tgrid.apply_field(f, (3,) + S3, torch.float32, vector=True)
    fj = jgrid.apply_field(f, (3,) + S3, jnp.float32, vector=True)
    assert_exact(ft, fj)
    g = lambda x: x[1] * x[1]
    assert_exact(tgrid.apply_field(g, S3, torch.float32),
                 jgrid.apply_field(g, S3, jnp.float32))
    # a constant point function broadcasts like JAX's vmap
    c = tgrid.apply_field(lambda i, x: 1.5, (3,) + S3, torch.float32,
                          vector=True)
    assert bool((c == 1.5).all())


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("perdir", [(), (1,), (0, 2)])
@pytest.mark.parametrize("save_exit", [False, True])
def test_bc_vector_bitwise(dtype, perdir, save_exit):
    u = normal(5, (3,) + S3, dtype)
    A = (1.0, 0.5, -0.25)
    ref = jbc.bc_vector(jj(u), A, save_exit, perdir)
    assert_exact(tbc.bc_vector(tt(u), A, save_exit, perdir), ref)
    # the bc3d wrapper on a CPU tensor runs the same plain version
    assert_exact(sk.bc3d(tt(u), A, save_exit, perdir), ref)


@pytest.mark.parametrize("S", [(10, 9, 12), (14, 12, 10)])
def test_bc3d_plain_matches_pallas(S):
    """The kernel's plain version equals the Pallas bc3d kernel (interpret
    mode) bit for bit, ghost corners included; 10 % 4 leaves a ragged
    slab tail."""
    u = normal(6, (3,) + S)
    A = (1.0, 0.0, 0.0)
    assert_exact(sk.bc3d(tt(u), A), bc3d_pallas(jj(u), A, interpret=True))


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("perdir", [(), (1,), (0, 2)])
@pytest.mark.parametrize("save_exit", [False, True])
def test_bc_vector_inplace_bitwise(dtype, perdir, save_exit):
    """``inplace=True`` fills the given tensor itself and returns it, equal
    to JAX's `bc_vector` bit for bit (the bc3d wrapper's CPU form too)."""
    u = normal(5, (3,) + S3, dtype)
    A = (1.0, 0.5, -0.25)
    ref = jbc.bc_vector(jj(u), A, save_exit, perdir)
    for fill in (tbc.bc_vector, sk.bc3d):
        t = tt(u)
        out = fill(t, A, save_exit, perdir, inplace=True)
        assert out is t
        assert_exact(t, ref)


def test_bc_vector_input_untouched():
    u = tt(normal(7, (3,) + S3))
    u0 = u.clone()
    tbc.bc_vector(u, (1.0, 0.0, 0.0))
    assert torch.equal(u, u0)


@pytest.mark.parametrize("perdir", [(0,), (1, 2)])
def test_bc_scalar_periodic(perdir):
    a = normal(8, S3)
    assert_exact(tbc.bc_scalar_periodic(tt(a), perdir),
                 jbc.bc_scalar_periodic(jj(a), perdir))


@pytest.mark.parametrize("dtype", [F32, F64])
def test_exit_bc(dtype):
    u = normal(9, (3,) + S3, dtype)
    u0 = normal(10, (3,) + S3, dtype)
    dt = dtype(0.3)
    ref = jbc.exit_bc(jj(u), jj(u0), (jnp.asarray(1.0, JAX[dtype]),) * 3,
                      jnp.asarray(dt))
    got = tbc.exit_bc(tt(u), tt(u0), (1.0, 1.0, 1.0), torch.tensor(dt))
    assert_rel(got, ref, 1e-6 if dtype is F32 else 1e-12)


def test_gates_read_the_device():
    """The kernel gates read "tensor on CUDA" where JAX reads "backend is
    TPU", with the same size, rank and dtype conditions."""
    cuda, cpu, f32 = torch.device("cuda"), torch.device("cpu"), torch.float32
    fine = (98, 66, 66)
    assert sk.use_blocked(fine, f32, cuda)
    assert sk.use_blocked((3, 200, 200), f32, cuda)       # no slab minimum
    assert not sk.use_blocked(fine, f32, cpu)
    assert not sk.use_blocked(fine, torch.float64, cuda)
    assert not sk.use_blocked((50, 34, 34), f32, cuda)    # below MIN_CELLS
    assert not sk.use_blocked((1026, 1026), f32, cuda)    # 2D


def test_wrappers_refuse_other_devices():
    u = torch.zeros((3, 6, 5, 4), device="meta")
    with pytest.raises(ValueError, match="not supported"):
        sk.bc3d(u, (0.0, 0.0, 0.0))
    with pytest.raises(ValueError, match="not supported"):
        sk.cfl3d(u)


def test_port_imports_without_jax():
    """The port never imports jax or waterlily_tpu: with both made
    unimportable, the whole package imports and steps a tiny case."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['waterlily_tpu'] = None\n"
        "import torch\n"
        "import waterlily_tpu_torch\n"
        "from waterlily_tpu_torch import convert, utils\n"
        "from waterlily_tpu_torch.utils import perf\n"
        "from waterlily_tpu_torch.kernels import build\n"
        "from waterlily_tpu_torch.ops import pcg_kernel\n"
        "sim = waterlily_tpu_torch.sphere_3d(16, 16, device='cpu')\n"
        "sim.step(remeasure=False)\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules"
        " if sys.modules[m] is not None)\n"
        "print('ok', sim.pois_n)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         cwd=Path(__file__).resolve().parent.parent)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
