"""Reverse-mode (adjoint) objective gradients through the stiff solve, in
PyTorch.

Counterpart of ``kinetica_tpu/solving/adjoint.py``: ``grad[j] = d g(u(T))
/ d ln k_j`` from ONE backward stiff solve, whatever the number of
reactions. The method is the reference's continuous adjoint:

1. a forward solve storing ``u`` and ``f(u)`` on an endpoint-graded grid
   (geometric stacks resolving 12 decades of boundary layer at both ends);
2. ``u(t)`` between nodes by C^1 cubic Hermite interpolation, its slopes
   f(u) at the nodes. The port stores u for it on a graded grid of
   ``n_store`` nodes, 32x finer than the quadrature grid by default,
   where the reference uses the quadrature grid. The backward Jacobian
   reads u from this interpolant, and a slope f(u) of a fast
   (quasi-steady) species carries J times the node's error in u: on
   ``synthetic_pyrolysis_network(24)`` at 650 K the top gradient came out
   32-148% off its central difference from 257 nodes, 0.03-1.6% from 2049
   depending on rounding, and 0.05% from 8193, with 40% fewer backward
   steps (``kinetica_tpu_torch.scripts.adjoint_storage``);
3. the adjoint ODE in reversed time ``s = T - t``, ``mu' = +J(u(T - s))^T
   mu`` from the unit-normalised ``dg/du(T)``, through the same BDF
   integrator. Its RHS is the ODE itself, so it uses the f64 analytic
   Jacobian; the Newton Jacobian of that solve is the preconditioner, f32
   under ``jac_dtype="auto"`` as in the forward solve, and its factor is
   built by the kernels of ``pars.linsolve``;
4. ``grad_j = int_0^T lambda . (N_j r_j(u(t))) dt`` by panel quadrature
   of the nodal integrand: the exponential rule on sign-constant panels
   that vary geometrically, the trapezoid elsewhere.

The gradient of an ``objective(u_T)`` comes from ``torch.autograd``. v1
scope, as the reference: static conditions and one time segment.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import DEFAULT_DEVICE
from ..ops import bdf
from ..utils.logging import logger

# the backward solve's statistics of the last call (steps, factors, ...)
last_stats: dict = {}


def _graded_grid(T: float, n_nodes: int) -> np.ndarray:
    """Endpoint-clustered node set on [0, T]: geometric stacks spanning
    relative scales 1e-12..0.4 at both ends plus a uniform interior."""
    n_geo = max(n_nodes // 3, 24)
    n_mid = max(n_nodes - 2 * n_geo, 9)
    left = np.geomspace(1e-12, 0.4, n_geo)
    mid = np.linspace(0.4, 0.6, n_mid)
    pts = np.unique(np.concatenate(
        [[0.0], left, mid, 1.0 - left[::-1], [1.0]]))
    return T * pts


def _hermite_interpolant(grid: torch.Tensor, vals: torch.Tensor,
                         slopes: torch.Tensor):
    """C^1 cubic Hermite over a (possibly non-uniform) grid from nodal
    values and slopes (n, ns); the result maps times (B,) to (B, ns)."""
    n = grid.shape[0]

    def of_t(t: torch.Tensor) -> torch.Tensor:
        i = torch.clamp(torch.searchsorted(grid, t.contiguous(), right=True)
                        - 1, 0, n - 2)
        h = (grid[i + 1] - grid[i])[:, None]
        th = (t[:, None] - grid[i][:, None]) / h
        h00 = (1.0 + 2.0 * th) * (1.0 - th) ** 2
        h10 = th * (1.0 - th) ** 2
        h01 = th ** 2 * (3.0 - 2.0 * th)
        h11 = th ** 2 * (th - 1.0)
        return (h00 * vals[i] + (h * h10) * slopes[i]
                + h01 * vals[i + 1] + (h * h11) * slopes[i + 1])

    return of_t


def _stats(res) -> dict:
    return {k: int(getattr(res, k)[0])
            for k in ("n_steps", "n_rejected", "n_jev", "n_lu")}


def solve_adjoint_gradient(method, sd, rd, weights=None, objective=None,
                           n_nodes: int = 257, copy_network: bool = True,
                           device=DEFAULT_DEVICE, n_store: int | None = None):
    """Gradient of a terminal objective w.r.t. every ``ln k_j``, on ``device``.

    The objective is either linear, ``g = weights . u(T)`` with a (ns,)
    ``weights`` vector, or a differentiable scalar ``objective(u_T)`` of
    a (ns,) f64 tensor (e.g. a least-squares misfit), whose gradient
    seeds the adjoint. ``method`` must be a :class:`~kinetica_tpu_torch
    .solving.methods.StaticODESolve`; ``n_nodes`` sets the graded
    quadrature grid, ``n_store`` the graded grid u is interpolated from
    (default ``32 (n_nodes - 1) + 1``; ``n_store=n_nodes`` is the
    reference's method).

    Returns ``(grad, g)``: the (nr,) gradient in the active (filtered)
    network's reaction order, as numpy, and the objective value.
    """
    from .methods import StaticODESolve, _jac_dtype, solve_network
    from .solve_utils import get_initial_rates

    if not isinstance(method, StaticODESolve):
        raise TypeError("solve_adjoint_gradient requires a StaticODESolve "
                        "(v1 supports time-invariant rate constants)")
    if (weights is None) == (objective is None):
        raise ValueError("pass exactly one of weights / objective")
    if n_nodes < 64:
        raise ValueError("n_nodes must be >= 64 (graded grid needs both "
                         "endpoint stacks + interior)")

    integ = solve_network(method, sd, rd, copy_network=copy_network,
                          return_integrator=True, device=device)
    pars = method.pars
    net = integ.net.to_dtype(torch.float64)
    dev = net.N.device
    f64 = dict(dtype=torch.float64, device=dev)
    k = torch.as_tensor(get_initial_rates(method.conditions,
                                          method.calculator), **f64)
    if k.shape[0] != net.nr:
        raise RuntimeError("calculator rate-vector length does not match "
                           "the active network")
    if weights is not None:
        w0 = torch.as_tensor(np.asarray(weights, dtype=np.float64), **f64)
        if w0.shape != (net.ns,):
            raise ValueError(f"weights must have shape ({net.ns},)")

    T = float(pars.tspan[1] - pars.tspan[0])
    grid = torch.as_tensor(_graded_grid(T, n_nodes), **f64)
    n_store = 32 * (n_nodes - 1) + 1 if n_store is None else int(n_store)
    grid_u = torch.as_tensor(_graded_grid(T, n_store), **f64)
    nodes = torch.unique(torch.cat([grid, grid_u]))          # sorted

    # ---- forward: dense storage on both graded grids (u exact at t=0) ----
    res_f = integ.solve_segment(0.0, T, saveat=nodes[1:])
    if int(res_f.status[0]) != bdf.DONE:
        raise RuntimeError(f"forward solve failed "
                           f"(status {int(res_f.status[0])})")
    u_all = torch.cat([integ.u0[None], res_f.ys[0]]).to(torch.float64)
    us = u_all[torch.searchsorted(nodes, grid)]
    us_u = u_all[torch.searchsorted(nodes, grid_u)]
    u_of_t = _hermite_interpolant(grid_u, us_u, net.rhs(us_u, k))
    if weights is not None:
        w = w0
        g = float(w @ us[-1])
    else:
        u_T = us[-1].detach().clone().requires_grad_(True)
        obj = objective(u_T)
        g = float(obj.detach())
        w = torch.autograd.grad(obj, u_T)[0].to(torch.float64)

    # ---- backward: mu(s) = lambda(T - s), mu' = +J(u(T-s))^T mu ----
    # a linear ODE: solved from the terminal condition normalised to unit
    # infinity norm (objective-scale-free tolerances), rescaled after
    w_scale = float(w.abs().max())
    if w_scale == 0.0:
        return np.zeros(net.nr), g
    w_hat = w / w_scale
    s_grid = torch.flip(T - grid, dims=(0,))     # graded s-nodes, increasing
    jdt = _jac_dtype(pars)
    jac_net = net.to_dtype(jdt)

    def rhs_b(s, mu, kk):
        J = net.jac(u_of_t(T - s), kk)
        return torch.einsum("bij,bi->bj", J, mu)

    def jac_b(s, mu, kk):
        return jac_net.jac_matmul(u_of_t(T - s).to(jdt),
                                  kk.to(jdt)).transpose(-1, -2)

    res_b = bdf.bdf_solve(
        rhs_b, jac_b, w_hat[None], 0.0, T, s_grid[1:], rtol=1e-7, atol=1e-10,
        max_steps=int(pars.maxiters), nonnegative=False,
        nonnegative_project=False, linsolve=pars.linsolve,
        lu_drift_tol=pars.lu_drift_tol, jac_policy=pars.jac_policy,
        args=k[None])
    last_stats.clear()
    last_stats.update(forward=_stats(res_f), backward=_stats(res_b))
    if int(res_b.status[0]) != bdf.DONE:
        raise RuntimeError(f"adjoint solve failed "
                           f"(status {int(res_b.status[0])})")
    mus = torch.cat([w_hat[None], res_b.ys[0]])
    lams = torch.flip(mus, dims=(0,)) * w_scale   # lambda at the t-grid nodes

    # ---- panel quadrature of the nodal integrand over the graded grid:
    # the exponential rule  int ~ h (q1 - q0) / ln(q1/q0)  where the
    # integrand keeps its sign and varies geometrically (exact for pure
    # exponential decay, the boundary-layer behaviour), else the
    # trapezoid. lambda is not interpolated: its Hermite slopes reach
    # |J| |lambda| in the layer and overshoot.
    Q = net.rates(us, k) * (lams @ net.N.T)
    h_panel = (grid[1:] - grid[:-1])[:, None]
    q0, q1 = Q[:-1], Q[1:]
    tiny = torch.finfo(torch.float64).tiny
    logr = (torch.log(torch.clamp(q1.abs(), min=tiny))
            - torch.log(torch.clamp(q0.abs(), min=tiny)))
    expo_ok = (q0 * q1 > 0.0) & (logr.abs() > 1e-3)
    panel = torch.where(expo_ok,
                        h_panel * (q1 - q0)
                        / torch.where(expo_ok, logr, torch.ones_like(logr)),
                        0.5 * h_panel * (q0 + q1))
    grad = panel.sum(dim=0).cpu().numpy()
    logger.info(" - adjoint gradient: |grad|_max = %.3e at g = %.6g",
                float(np.abs(grad).max()), g)
    return grad, g
