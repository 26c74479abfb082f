"""Runtime launch calls (every cudaLaunch*/cuLaunch* and graph launch) the
profiler recorded over the traced steps, a step."""


def read(run):
    tr = run["trace"]
    if tr is None:
        return None
    return tr["launches"] / tr["steps"]
