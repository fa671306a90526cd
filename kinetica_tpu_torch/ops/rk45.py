"""Adaptive explicit Runge-Kutta (Dormand-Prince 5(4)), batched over lanes,
in PyTorch.

Counterpart of ``kinetica_tpu/ops/rk45.py``: the same tableau, error
norm, step-factor clamps, quartic dense output, stop clamping and status
codes. The reference writes one solve as a ``lax.while_loop`` and batches
it with ``vmap``; here every field is a (B, ...) tensor with its own t, h
and status, each step is computed for all lanes and merged into the
running ones, and a lane that is done stays frozen. The loop is driven
from the host, with one counted read a step (:mod:`.host_sync`).

Time and step size are f64; the state keeps the dtype of ``y0``.
"""
from __future__ import annotations

import inspect
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..utils.profiling import spanned
from . import host_sync

RUNNING, DONE, FAIL_MAX_STEPS, FAIL_H_UNDERFLOW = 0, 1, -1, -2

# Dormand-Prince 5(4) tableau
_C = np.array([0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0])
_A = [
    [],
    [1 / 5],
    [3 / 40, 9 / 40],
    [44 / 45, -56 / 15, 32 / 9],
    [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
    [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
    [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84],
]
_B = np.array([35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0])
_B_ERR = _B - np.array([5179 / 57600, 0.0, 7571 / 16695, 393 / 640,
                         -92097 / 339200, 187 / 2100, 1 / 40])
# dense output (quartic interpolant) coefficients for DP5
_P = np.array([
    [1.0, -8048581381 / 2820520608, 8663915743 / 2820520608, -12715105075 / 11282082432],
    [0.0, 0.0, 0.0, 0.0],
    [0.0, 131558114200 / 32700410799, -68118460800 / 10900136933, 87487479700 / 32700410799],
    [0.0, -1754552775 / 470086768, 14199869525 / 1410260304, -10690763975 / 1880347072],
    [0.0, 127303824393 / 49829197408, -318862633887 / 49829197408, 701980252875 / 199316789632],
    [0.0, -282668133 / 205662961, 2019193451 / 616988883, -1453857185 / 822651844],
    [0.0, 40617522 / 29380423, -110615467 / 29380423, 69997945 / 29380423],
])


class RK45Results(NamedTuple):
    ys: torch.Tensor          # (B, n_save, ns)
    status: torch.Tensor
    t: torch.Tensor
    y_final: torch.Tensor
    n_steps: torch.Tensor
    n_accepted: torch.Tensor
    n_rejected: torch.Tensor
    h: torch.Tensor
    n_fev: torch.Tensor       # the port's own, after the reference's fields


def _rms(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(x * x, dim=-1))


def _adapt(fn: Callable, args) -> Callable:
    """``fn`` as ``f(t, y, t_start)``: a RHS of four parameters gets
    ``(t, y, args, t_start)``, of three ``(t, y, args)``, else ``(t, y)``."""
    try:
        n = len(inspect.signature(fn).parameters)
    except (TypeError, ValueError):
        n = 3
    if n >= 4:
        return lambda t, y, t_start: fn(t, y, args, t_start)
    if n == 3:
        return lambda t, y, t_start: fn(t, y, args)
    return lambda t, y, t_start: fn(t, y)


@spanned("rk45.solve")
def rk45_solve(rhs: Callable, y0: torch.Tensor, t0: float, tf: float, saveat,
               rtol=1e-6, atol=1e-9, stops=None, max_steps: int = 100000,
               first_step=None, nonnegative: bool = False,
               args=None) -> RK45Results:
    """Integrate ``dy/dt = rhs(t, y[, args[, t_start]])`` for a batch of
    lanes with adaptive DP5(4).

    ``y0`` is (B, ns); ``t`` reaches the RHS as a (B,) f64 tensor, and
    ``t_start`` is the start of the step the stage belongs to. ``saveat``
    lists increasing times in (t0, tf]; ``stops`` (n,) or (B, n) sorted
    times no step straddles (+inf padded); ``first_step`` a float or (B,)
    tensor replacing the automatic initial step; ``rtol`` and ``atol``
    floats or (B,) tensors.
    """
    f = _adapt(rhs, args)
    dev, dtype = y0.device, y0.dtype
    B, ns = y0.shape
    f64 = dict(dtype=torch.float64, device=dev)
    i64 = dict(dtype=torch.int64, device=dev)
    t0, tf = float(t0), float(tf)
    rtol = torch.as_tensor(rtol, dtype=dtype, device=dev).expand(B)[:, None]
    atol = torch.as_tensor(atol, dtype=dtype, device=dev).expand(B)[:, None]
    saveat = torch.as_tensor(saveat, **f64).reshape(-1)
    n_save = saveat.shape[0]
    if stops is None:
        stops = torch.full((1,), float("inf"), **f64)
    stops = torch.as_tensor(stops, **f64)
    if stops.ndim == 1:
        stops = stops.expand(B, -1)
    stops = stops.contiguous()
    n_stops = stops.shape[1]
    # time is f64: its resolution (the reference's is the state dtype's,
    # the same for an f64 state)
    eps = torch.finfo(torch.float64).eps
    tol_t = 4 * eps * max(abs(tf), 1.0)
    tiny = torch.finfo(torch.float64).tiny
    lanes = torch.arange(B, device=dev)
    jsave = torch.arange(n_save, device=dev)
    b5 = torch.as_tensor(_B, dtype=dtype, device=dev)
    b_err = torch.as_tensor(_B_ERR, dtype=dtype, device=dev)
    P = torch.as_tensor(_P, dtype=dtype, device=dev)

    t = torch.full((B,), t0, **f64)
    f0 = f(t, y0, t)
    scale0 = atol + y0.abs() * rtol
    d0, d1 = _rms(y0 / scale0), _rms(f0 / scale0)
    h = torch.where((d0 < 1e-5) | (d1 < 1e-5), torch.full_like(d0, 1e-6),
                    0.01 * d0 / d1).to(torch.float64)
    if first_step is not None:
        h = torch.as_tensor(first_step, **f64).expand(B).clone()
    h = torch.clamp(h, max=tf - t0)

    y, fcur = y0, f0
    status = torch.full((B,), RUNNING, **i64)
    n_steps = torch.zeros(B, **i64)
    n_acc = torch.zeros(B, **i64)
    n_rej = torch.zeros(B, **i64)
    save_ptr = torch.full((B,), int(torch.searchsorted(
        saveat, torch.tensor([t0], **f64), right=True)[0]), **i64)
    ys = torch.zeros(B, n_save, ns, dtype=dtype, device=dev)
    stop_ptr = torch.searchsorted(stops, torch.full((B, 1), t0 + tol_t,
                                                    **f64))[:, 0]

    while True:
        run = status == RUNNING
        if not host_sync.any_true(run, "rk45.loop"):
            break
        h_min = t.abs() * eps * 10 + tiny * 1e4
        sp = torch.clamp(stop_ptr, max=n_stops - 1)
        next_stop = torch.where(stop_ptr < n_stops, stops[lanes, sp],
                                torch.full_like(t, float("inf")))
        t_bound = torch.clamp(next_stop, max=tf)
        clamp = (t + 1.02 * h) >= (t_bound - tol_t)
        hc = torch.where(clamp, torch.maximum(t_bound - t, h_min), h)
        t_new = torch.where(clamp, t_bound, t + hc)
        hs = hc.to(dtype)[:, None]

        ks = [fcur]
        for i in range(1, 7):
            incr = sum(_A[i][j] * ks[j] for j in range(i))
            ti = t_new if i == 6 else t + float(_C[i]) * hc
            ks.append(f(ti, y + hs * incr, t))
        K = torch.stack(ks, dim=1)                          # (B, 7, ns)
        y_new = y + hs * torch.einsum("i,bin->bn", b5, K)
        err = hs * torch.einsum("i,bin->bn", b_err, K)
        scale = atol + rtol * torch.maximum(y.abs(), y_new.abs())
        err_norm = _rms(err / scale)
        neg = (torch.full_like(run, nonnegative)
               & (y_new.amin(dim=1) < 0.0))
        accept = (err_norm <= 1.0) & ~neg & torch.isfinite(y_new).all(dim=1)

        factor = torch.where(err_norm > 0, 0.9 * err_norm ** -0.2,
                             torch.full_like(err_norm, 10.0))
        factor = torch.clamp(factor, 0.2, 10.0)
        factor = torch.where(torch.isfinite(factor) & (factor > 0), factor,
                             torch.full_like(factor, 0.5))
        factor = torch.where(neg, torch.clamp(factor, max=0.5), factor)
        factor = factor.to(torch.float64)

        # dense output at the save points in (t, t_new]
        x = ((saveat[None, :] - t[:, None]) / hc[:, None]).to(dtype)
        xp = torch.stack([x, x ** 2, x ** 3, x ** 4], dim=-1)  # (B, n_save, 4)
        coeff = xp @ P.T                                      # (B, n_save, 7)
        yq = y[:, None] + hs[:, :, None] * (coeff @ K)
        hit = ((jsave[None, :] >= save_ptr[:, None])
               & (saveat[None, :] <= (t_new + tol_t)[:, None]))
        done = t_new >= tf - tol_t
        at_stop = (t_new - next_stop).abs() <= tol_t

        acc = run & accept
        rej = run & ~accept
        a1 = acc[:, None]
        t = torch.where(acc, t_new, t)
        y = torch.where(a1, y_new, y)
        fcur = torch.where(a1, K[:, 6], fcur)
        h = torch.where(acc, torch.where(clamp, h, hc * factor),
                        torch.where(rej, hc * torch.clamp(factor, max=0.9), h))
        ys = torch.where((acc[:, None] & hit)[:, :, None], yq, ys)
        save_ptr = torch.where(acc, save_ptr + hit.sum(dim=1), save_ptr)
        stop_ptr = torch.where(acc, stop_ptr + at_stop.long(), stop_ptr)
        n_acc = n_acc + acc.long()
        n_rej = n_rej + rej.long()
        n_steps = n_steps + run.long()
        st = torch.where(acc & done, DONE, status)
        st = torch.where(
            st == DONE, DONE,
            torch.where(n_steps >= max_steps, FAIL_MAX_STEPS,
                        torch.where(h < h_min, FAIL_H_UNDERFLOW, RUNNING)))
        status = torch.where(run, st, status)

    return RK45Results(ys=ys, status=status, t=t, y_final=y, n_steps=n_steps,
                       n_accepted=n_acc, n_rejected=n_rej,
                       n_fev=1 + 6 * n_steps, h=h)
