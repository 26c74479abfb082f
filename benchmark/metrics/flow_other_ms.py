"""Device ms a step launched inside `flow.mom_step` but outside its
`conv_diff` and `ml_solve` calls: BDIM, the boundary conditions,
accelerate, the divergence, the pressure correction and the CFL step."""


def read(run):
    tr = run["trace"]
    if tr is None or tr["range_calls"].get("mom_step", 0) == 0:
        return None
    r = tr["range_s"]
    other = (r.get("mom_step", 0.0) - r.get("conv_diff", 0.0)
             - r.get("ml_solve", 0.0))
    return other * 1e3 / tr["steps"]
