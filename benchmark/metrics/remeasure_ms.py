"""Device ms a step launched inside `Simulation.measure` (the body's
band measurement and the rebuilt multigrid levels) over the traced
steps; nothing where no step remeasured."""


def read(run):
    tr = run["trace"]
    if tr is None or tr["range_calls"].get("measure", 0) == 0:
        return None
    return tr["range_s"].get("measure", 0.0) * 1e3 / tr["steps"]
