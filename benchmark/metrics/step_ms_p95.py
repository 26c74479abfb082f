"""The 95th percentile of the wall time of every step of the window, each
timed by the host clock between step returns (a step ends in its host
read of dt): `statistics.quantiles`, exclusive method."""
import statistics


def read(run):
    s = run["step_s"]
    if len(s) < 2:
        return max(s) * 1e3
    return statistics.quantiles(s, n=20)[18] * 1e3
