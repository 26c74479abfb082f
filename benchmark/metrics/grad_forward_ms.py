"""Stream ms a traced unit of the forward half of a reverse step: the
step with its velocity and viscosity tracked, and the loss (the
program's ``wl.grad.forward`` spans, CUDA events at entry and exit,
`waterlily_tpu_torch.utils.perf.span_totals`, over its ``wl.sim.step``
roots); nothing where the program keeps no such spans."""


def read(run):
    tr = run["trace"]
    if tr is None:
        return None
    try:
        from waterlily_tpu_torch.utils.perf import span_totals
    except ImportError:
        return None
    got = span_totals(tr["steps"])
    if "wl.sim.step" not in got or "wl.grad.forward" not in got:
        return None
    ms = got["wl.grad.forward"]["stream_ms"]
    return None if ms is None else ms / got["wl.sim.step"]["calls"]
