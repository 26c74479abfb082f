"""The share of the traced steps' wall time in which no operation ran on
the device (its busy intervals merged), in percent."""


def read(run):
    tr = run["trace"]
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
