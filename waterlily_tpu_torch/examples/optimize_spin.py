"""Gradient-based design: the spin ratio of a rotating cylinder that hits
a target lift, by differentiating through the whole solver.

Reverse mode end to end: body map -> BDIM measurement -> momentum step ->
multigrid pressure solve -> surface force, by ``torch.autograd``.  The
pressure solve is a fixed-trip unroll (``fixed_iters=1``), or with
``--implicit`` the adaptive, converged solve whose backward pass is one
adjoint Poisson solve a projection (``implicit_diff=True``,
`ops.multigrid.ml_solve_implicit`): the mode whose memory does not grow
with the iterations.  The reference is forward-mode only (ForwardDiff,
maintests.jl:254-278).

The fields are f64 on every device: the problem is 18x18 and the loss is
compared against a tight target; on a card the f64 fields take the plain
forms (the kernels are f32), the pressure solves included.

Run:  python -m waterlily_tpu_torch.examples.optimize_spin [--implicit]
      [--quick] [--device cpu]
"""
import torch

from waterlily_tpu_torch.body import AutoBody, measure_fields
from waterlily_tpu_torch.examples import parser
from waterlily_tpu_torch.flow import FlowConfig, flow_init, mom_step
from waterlily_tpu_torch.metrics import total_force
from waterlily_tpu_torch.ops.multigrid import build_levels

f64 = torch.float64
Dm, Re, U = 8, 500, 1.0          # cylinder diameter (cells), Reynolds, speed
R = Dm // 2
S = (2 * Dm + 2, 2 * Dm + 2)
CL_TARGET = -2.0                 # target lift coefficient after 3 steps


def lift_coeff(xi, device, implicit=False):
    """Lift coefficient of a cylinder spinning at tip-speed ratio ``xi``
    (a 0-d tensor) after 3 impulsive-start steps."""
    def sdf(x, t):
        return torch.sqrt(torch.sum(x * x)) - R

    def mp(x, t):                # rotate the body frame at rate xi*U/R
        a = xi * U * t / R
        s, c = torch.sin(a), torch.cos(a)
        Rm = torch.stack([torch.stack([c, -s]), torch.stack([s, c])])
        return Rm.to(x.dtype) @ (x - Dm)

    body = AutoBody(sdf, mp)
    ad = (dict(implicit_diff=True, tol=1e-12, itmx=64) if implicit
          else dict(fixed_iters=1))
    cfg = FlowConfig(D=2, S=S, device=device, nu=U * Dm / Re, U=(U, 0.0),
                     dtype=f64, **ad)
    state = flow_init(cfg)
    V, m0, m1, _ = measure_fields(body, S, 0.0, 1.0, (), False, f64, device)
    state = state.replace(V=V, mu0=m0, mu1=m1)
    levels = build_levels(m0)
    for _ in range(3):
        state, _aux = mom_step(cfg, levels, state)
    f = total_force(state.u, state.p, cfg.nu, body, state.t)
    return 2 * f[1] / (U ** 2 * Dm)


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("--implicit", action="store_true",
                   help="adjoint by implicit differentiation")
    args = p.parse_args(argv)
    xi = torch.tensor(1.0, dtype=f64, device=args.device)
    losses = []
    print("it   xi       Cl        loss      dloss/dxi")
    for it in range(2 if args.quick else 12):
        xi = xi.detach().requires_grad_()
        cl = lift_coeff(xi, args.device, args.implicit)
        loss = (cl - CL_TARGET) ** 2
        (g,) = torch.autograd.grad(loss, xi)
        losses.append(float(loss.detach()))
        print(f"{it:2d}  {float(xi.detach()):6.3f}  {float(cl.detach()):8.4f}"
              f"  {losses[-1]:9.2e}  {float(g):+9.2e}")
        if losses[-1] < 1e-6:
            break
        xi = xi.detach() - 0.25 * g       # plain gradient descent
    print(f"\noptimized spin ratio xi = {float(xi):.4f} "
          f"(Cl = {float(cl.detach()):.4f}, target {CL_TARGET})")
    return losses


if __name__ == "__main__":
    main()
