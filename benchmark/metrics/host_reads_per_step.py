"""Blocking device-to-host reads a traced step: the calls of the
program's ``wl.read.*`` spans (`waterlily_tpu_torch.utils.perf.
span_totals`) over its ``wl.sim.step`` roots, the last ``steps`` recorded,
which are the traced steps (the program records only under a profiler);
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
    if "wl.sim.step" not in got:
        return None
    reads = sum(v["calls"] for k, v in got.items()
                if k.startswith("wl.read."))
    return reads / got["wl.sim.step"]["calls"]
