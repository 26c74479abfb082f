"""Stream ms of the fine level's PCG smooth that ends each solver
iteration (the program's ``wl.solve.smooth`` spans, CUDA events at entry
and exit, `waterlily_tpu_torch.utils.perf.span_totals`) over the
iterations of the traced steps; nothing where the program keeps no
spans."""


def read(run):
    tr = run["trace"]
    if tr is None:
        return None
    try:
        from waterlily_tpu_torch.utils.perf import span_totals
    except ImportError:
        return None
    got = span_totals(tr["steps"]).get("wl.solve.smooth")
    iters = sum(sum(n) for n in tr["pois"])
    if got is None or got["stream_ms"] is None or iters == 0:
        return None
    return got["stream_ms"] / iters
