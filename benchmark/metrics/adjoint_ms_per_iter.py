"""Stream ms of the adjoint pressure solves of a reverse step (the
program's ``wl.solve.adjoint`` spans, CUDA events at entry and exit,
`waterlily_tpu_torch.utils.perf.span_totals`) over their iterations in
the traced units (each unit's counts ``[pred, corr, adj_1, adj_2]``);
nothing where the program keeps no such spans or counts."""


def read(run):
    tr = run["trace"]
    if tr is None:
        return None
    try:
        from waterlily_tpu_torch.utils.perf import span_totals
    except ImportError:
        return None
    got = span_totals(tr["steps"]).get("wl.solve.adjoint")
    iters = sum(sum(n[2:]) for n in tr["pois"])
    if got is None or got["stream_ms"] is None or iters == 0:
        return None
    return got["stream_ms"] / iters
