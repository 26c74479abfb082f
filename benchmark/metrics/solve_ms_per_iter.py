"""Device ms launched inside the `ml_solve` calls of the traced steps over
the iterations they ran."""


def read(run):
    tr = run["trace"]
    if tr is None:
        return None
    iters = sum(sum(n) for n in tr["pois"])
    spent = tr["range_s"].get("ml_solve", 0.0)
    if iters == 0 or spent <= 0:
        return None
    return spent * 1e3 / iters
