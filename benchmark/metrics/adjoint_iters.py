"""Adjoint pressure-solve iterations a reverse step (both solves), summed
from the unit's counts ``[pred, corr, adj_1, adj_2]`` over every unit of
the window; nothing where the units count no adjoint solve."""


def read(run):
    adj = [sum(n[2:]) for n in run["pois"] if len(n) > 2]
    if not adj:
        return None
    return sum(adj) / len(adj)
