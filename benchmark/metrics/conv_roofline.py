"""The least time of the work the `conv_diff` calls need (the frozen model
of `work.py`: six f32 fields over the padded grid, 378 operations a
cell) over the device time launched inside them, in percent."""
from benchmark.work import least_seconds


def read(run):
    tr = run["trace"]
    if tr is None:
        return None
    calls = tr["range_calls"].get("conv_diff", 0)
    spent = tr["range_s"].get("conv_diff", 0.0)
    if calls == 0 or spent <= 0:
        return None
    least, _ = least_seconds("conv_diff", run["S"])
    return 100.0 * calls * least / spent
