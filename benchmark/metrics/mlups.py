"""Interior cells times steps completed in the window over the window's
wall seconds, in millions: all the work over all the time."""


def read(run):
    return run["cells"] * run["steps"] / run["window_s"] / 1e6
