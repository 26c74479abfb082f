"""Seconds `Simulation(...)` takes on the host clock, ended by a
synchronise: the initial field, the body measurement and the multigrid
levels."""


def read(run):
    return run["construct_s"]
