"""Pressure-solver iterations a step (both solves), summed from
`Simulation.pois_n` over every step of the window."""


def read(run):
    if not run["pois"]:
        return None
    return sum(sum(n) for n in run["pois"]) / len(run["pois"])
