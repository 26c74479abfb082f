"""Stream ms a traced step of the two BDIM blends with the scalings
beside them, dense or banded (the program's ``wl.flow.bdim`` spans, CUDA
events at entry and exit, `waterlily_tpu_torch.utils.perf.span_totals`);
nothing where the program keeps no spans."""


def read(run):
    tr = run["trace"]
    if tr is None:
        return None
    try:
        from waterlily_tpu_torch.utils.perf import span_totals
    except ImportError:
        return None
    got = span_totals(tr["steps"])
    if "wl.sim.step" not in got or "wl.flow.bdim" not in got:
        return None
    ms = got["wl.flow.bdim"]["stream_ms"]
    return None if ms is None else ms / got["wl.sim.step"]["calls"]
