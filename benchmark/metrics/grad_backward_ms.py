"""Stream ms a traced unit of the backward half of a reverse step: the
plain forms' vjps and the two adjoint pressure solves (the program's
``wl.grad.backward`` spans, CUDA events at entry and exit,
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
    if "wl.sim.step" not in got or "wl.grad.backward" not in got:
        return None
    ms = got["wl.grad.backward"]["stream_ms"]
    return None if ms is None else ms / got["wl.sim.step"]["calls"]
