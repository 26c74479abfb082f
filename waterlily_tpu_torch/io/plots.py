"""Plots (reference ext/WaterLilyPlotsExt.jl), with matplotlib.

PyTorch counterpart of `waterlily_tpu.io.plots`: `flood` filled contours,
`body_plot` the body's sdf zero contour, `sim_gif` an animation of the
vorticity, `plot_logger` the residual traces that `Simulation(log=True)`
and `write_log` record.  Matplotlib is imported inside each function
(`_plt`), so importing the port never needs it.
"""
from __future__ import annotations

import numpy as np

from ..convert import to_numpy

__all__ = ["flood", "body_plot", "sim_gif", "read_log", "plot_logger"]


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def flood(field, shift=(0.0, 0.0), clims=None, levels=10, cmap="RdBu_r",
          ax=None, **kw):
    """Filled contours of a 2D scalar field, its values clamped to
    ``clims`` (default ±max|field|) (reference PlotsExt.jl:17-27)."""
    plt = _plt()
    f = to_numpy(field).T
    if clims is not None:
        lo, hi = clims
        f = np.clip(f, lo, hi)
    else:
        m = np.max(np.abs(f))
        lo, hi = -m, m
    if ax is None:
        _, ax = plt.subplots()
    x = np.arange(f.shape[1]) + shift[0]
    y = np.arange(f.shape[0]) + shift[1]
    cs = ax.contourf(x, y, f, np.linspace(lo, hi, levels + 1), cmap=cmap,
                     extend="both", **kw)
    ax.set_aspect("equal")
    ax.axis("off")
    return cs


def body_plot(sim, t=None, ax=None, levels=(0,), color="black"):
    """Fill the body (sdf < 0) over a plot (reference PlotsExt.jl:29-33)."""
    from ..body import measure_sdf
    plt = _plt()
    t = sim.time if t is None else t
    d = to_numpy(measure_sdf(sim.body, sim.cfg.S, t, sim.cfg.dtype,
                           sim.device)).T
    if ax is None:
        ax = plt.gca()
    ax.contourf(d, levels=[-1e10, 0], colors=color)


def sim_gif(sim, fname="sim.gif", duration=1.0, step=0.1, remeasure=False,
            clims=None, plotbody=False, verbose=True):
    """Step the sim and save its z-vorticity ``curl(2, u)·L/U`` every
    ``step`` tU/L over ``duration`` as a gif (reference
    PlotsExt.jl:41-52)."""
    from ..metrics import curl
    plt = _plt()
    import matplotlib.animation as animation

    frames = []
    t0 = sim.sim_time
    t = t0
    while t < t0 + duration:
        t += step
        sim.sim_step(t, remeasure=remeasure)
        frames.append(to_numpy(curl(2, sim.flow.u)) * sim.L / sim.U)
        if verbose:
            print(f"tU/L={sim.sim_time:.2f}")
    fig, ax = plt.subplots()

    def draw(i):
        ax.clear()
        flood(frames[i], clims=clims or (-10, 10), ax=ax)
        if plotbody:
            body_plot(sim, ax=ax)
        return []

    ani = animation.FuncAnimation(fig, draw, frames=len(frames))
    ani.save(fname, writer="pillow", fps=int(1 / 0.05 * step) or 10)
    plt.close(fig)
    return fname


def read_log(fname="WaterLily.log"):
    """The predictor's and corrector's traces of a `write_log` file:
    two lists with one list of ``(iter, r∞, r₂)`` per step each."""
    pred, corr = [], []
    current = None
    with open(fname) as f:
        next(f)  # header
        for line in f:
            line = line.strip()
            if line in ("p", "c"):
                current = pred if line == "p" else corr
                current.append([])
            elif line.startswith(",") and current is not None:
                _, it, linf, r2 = [s.strip() for s in line.split(",")]
                current[-1].append((int(it), float(linf), float(r2)))
    return pred, corr


def plot_logger(fname="WaterLily.log", out="residuals.png"):
    """Plot the iteration counts and final residuals of the traces in a
    `write_log` file (reference PlotsExt.jl:60-100)."""
    plt = _plt()
    pred, corr = read_log(fname)
    fig, axes = plt.subplots(1, 3, figsize=(12, 4))
    for traces, color, label in ((pred, "C0", "predictor"),
                                 (corr, "C2", "corrector")):
        iters = [len(tr) - 1 for tr in traces if tr]
        rinf = [tr[-1][1] for tr in traces if tr]
        r2 = [tr[-1][2] for tr in traces if tr]
        axes[0].plot(iters, color=color, label=label)
        axes[1].semilogy(rinf, color=color, label=label)
        axes[2].semilogy(r2, color=color, label=label)
    for ax, title in zip(axes, ("MG iterations", "r∞", "r₂")):
        ax.set_title(title)
        ax.legend()
    fig.tight_layout()
    fig.savefig(out, dpi=100)
    plt.close(fig)
    return out
