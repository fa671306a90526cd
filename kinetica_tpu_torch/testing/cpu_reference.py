"""Pure-numpy mass-action reference for CPU baselines.

Builds the identical mass-action RHS/Jacobian that
:mod:`kinetica_tpu_torch.models.mass_action` computes on device, but in plain
numpy with NO torch or jax involvement anywhere — a scipy ``solve_ivp(BDF)`` over
these callables is the honest stand-in for the reference's recommended
``CVODE_BDF`` production solver (getting-started.md:69; Sundials is not
installable in this image).

Why this module exists: evaluating condition profiles through jnp inside
the scipy RHS put a device dispatch in every CPU-baseline step. With the
remote TPU registered, that inflated the r1/r2 "CPU baseline" ~13x
(64-98 s measured vs ~5 s true, and ~0.5 s quiet). Every CPU-vs-device
comparison must go through a baseline that never touches jax.
"""
from __future__ import annotations

import numpy as np

from .. import constants


def build_numpy_mass_action(sd, rd):
    """Dense numpy stoichiometry operators for the CRN.

    Returns ``(rhs_factory, jac_factory)`` where each factory takes a
    ``k_of_t(t) -> (nr,) ndarray`` callable and returns the scipy-signature
    ``f(t, y)`` RHS / Jacobian. Mirrors models/mass_action.py's slot
    formulation (reference: Catalyst ReactionSystem codegen,
    Julia reference src/solving/solve_utils.jl:318-349).
    """
    ns, nr = sd.n, rd.nr
    arity = max(2, max(sum(s) for s in rd.stoic_reacs))
    slots = np.full((nr, arity), ns, dtype=np.int64)
    N = np.zeros((nr, ns))
    for j in range(nr):
        s = 0
        for sid, st in zip(rd.id_reacs[j], rd.stoic_reacs[j]):
            N[j, sid] -= st
            for _ in range(st):
                slots[j, s] = sid
                s += 1
        for sid, st in zip(rd.id_prods[j], rd.stoic_prods[j]):
            N[j, sid] += st
    E = np.zeros((arity, nr, ns))
    for s in range(arity):
        valid = slots[:, s] < ns
        E[s, np.flatnonzero(valid), slots[valid, s]] = 1.0

    def rhs_factory(k_of_t):
        def rhs(t, y):
            u = np.append(y, 1.0)
            r = k_of_t(t) * u[slots].prod(axis=1)
            return r @ N
        return rhs

    def jac_factory(k_of_t):
        def jac(t, y):
            u = np.append(y, 1.0)
            k = k_of_t(t)
            su = u[slots]
            G = np.zeros((nr, ns))
            for s in range(arity):
                others = np.prod(np.delete(su, s, axis=1), axis=1)
                G += (k * others)[:, None] * E[s]
            return N.T @ G
        return jac

    return rhs_factory, jac_factory


def arrhenius_k_of_t(calc, profile):
    """Pure-numpy ``k(t)`` for a PrecalculatedArrheniusCalculator under a
    linear-ramp temperature profile (LinearGradientProfile /
    LinearDirectProfile semantics: ramp to t_end, then hold X_end)."""
    Ea_np, A_np = np.asarray(calc.Ea, float), np.asarray(calc.A, float)
    k_max = calc.k_max
    t_ramp_end = float(profile.t_end)
    T0, T_rate, T_end = (float(profile.X_start), float(profile.rate),
                         float(profile.X_end))

    def k_of_t(t):
        T = T0 + T_rate * t if t <= t_ramp_end else T_end
        k = A_np * np.exp(-Ea_np / (constants.R * T)) * constants.N_A
        if k_max is not None:
            k = 1.0 / (1.0 / k_max + 1.0 / k)
        return k

    return k_of_t


def scipy_bdf_baseline(sd, rd, calc, profile, tspan, u0, rtol, atol,
                       best_of: int = 3):
    """Single-profile scipy BDF solve; returns ``(best_seconds, final_y)``.

    best-of-N because the single-core host is shared and a contended core
    inflates the baseline (observed 0.48 s quiet vs 1.2 s under load); the
    MIN is the honest statement of the CPU's capability.
    """
    import time

    from scipy.integrate import solve_ivp

    rhs_f, jac_f = build_numpy_mass_action(sd, rd)
    k_of_t = arrhenius_k_of_t(calc, profile)
    rhs, jac = rhs_f(k_of_t), jac_f(k_of_t)
    dt = float("inf")
    for _ in range(best_of):
        t0 = time.perf_counter()
        sol = solve_ivp(rhs, tspan, u0, method="BDF", jac=jac,
                        rtol=rtol, atol=atol)
        dt = min(dt, time.perf_counter() - t0)
        assert sol.success, "CPU baseline failed"
    return dt, sol.y[:, -1]


def scipy_bdf_static(sd, rd, k, tf, u0, rtol, atol, clip_delta=None):
    """Static-rate scipy BDF from ``u0`` over [0, tf] under the (nr,)
    rate vector ``k``; returns the final state.

    With ``clip_delta`` the rates are evaluated on the solver's smooth
    nonnegative part ``u * sigmoid(u / clip_delta)`` (the Jacobian with
    its chain factor), so this is the ODE the solver integrates. Near a
    boundary steady state the plain ODE is unstable: a radical a
    tolerance below zero feeds its own quadratic consumption, and the
    solve stops ("required step size is less than spacing")."""
    from scipy.integrate import solve_ivp
    from scipy.special import expit

    rhs_f, jac_f = build_numpy_mass_action(sd, rd)
    k = np.asarray(k, float)
    rhs, jac = rhs_f(lambda t: k), jac_f(lambda t: k)
    if clip_delta is not None:
        rhs_plain, jac_plain = rhs, jac

        def rhs(t, y):
            return rhs_plain(t, y * expit(y / clip_delta))

        def jac(t, y):
            x = y / clip_delta
            s = expit(x)
            return jac_plain(t, y * s) * (s * (1.0 + x * (1.0 - s)))[None, :]
    sol = solve_ivp(rhs, (0.0, float(tf)), np.asarray(u0, float),
                    method="BDF", jac=jac, rtol=rtol, atol=atol)
    assert sol.success, f"CPU static baseline failed: {sol.message}"
    return sol.y[:, -1]


def scipy_bdf_discrete_baseline(sd, rd, calc, profile, tspan, u0, rtol, atol,
                                tstops):
    """Discrete-rate scipy BDF: the reference's discrete formalism on CPU.

    The rate vector k(T(tstops[i])) holds over [tstops[i], tstops[i+1])
    (before the first stop, the first row), as the solver's left-constant
    lookup reads it; the solve restarts at every stop, so no step straddles
    a change of k. ``profile`` is a linear ramp, as for
    :func:`arrhenius_k_of_t`. Returns the final state.
    """
    from scipy.integrate import solve_ivp

    rhs_f, jac_f = build_numpy_mass_action(sd, rd)
    k_of_t = arrhenius_k_of_t(calc, profile)
    tstops = np.asarray(tstops, float)
    t_lo, t_hi = float(tspan[0]), float(tspan[1])
    edges = np.unique(np.concatenate(
        [[t_lo, t_hi], tstops[(tstops > t_lo) & (tstops < t_hi)]]))
    u = np.asarray(u0, float)
    for a, b in zip(edges[:-1], edges[1:]):
        i = min(max(int(np.searchsorted(tstops, a, side="right")) - 1, 0),
                tstops.size - 1)
        k = k_of_t(tstops[i])
        sol = solve_ivp(rhs_f(lambda t: k), (a, b), u, method="BDF",
                        jac=jac_f(lambda t: k), rtol=rtol, atol=atol)
        assert sol.success, f"CPU discrete baseline failed on [{a}, {b}]"
        u = sol.y[:, -1]
    return u


def scipy_bdf_discrete_trajectory(sd, rd, calc, profile, ts, u0, rtol, atol,
                                  tstops):
    """:func:`scipy_bdf_discrete_baseline` read at the times ``ts`` (the
    first at the start of the span): a (len(ts), ns) array. The solve also
    restarts at every time of ``ts``, as a chunkwise solve restarts at
    every chunk."""
    ts = np.asarray(ts, float)
    out = [np.asarray(u0, float)]
    for a, b in zip(ts[:-1], ts[1:]):
        out.append(scipy_bdf_discrete_baseline(
            sd, rd, calc, profile, (a, b), out[-1], rtol, atol, tstops))
    return np.stack(out)


def collision_k_of_t(Ea, mu, sigma, rho, k_max, t_mult, profile):
    """Pure-numpy ``k(t)`` of the KPM collision-theory rate law
    (``sigma rho N_A sqrt(8 k_b T / pi mu) 1e3 e^{-Ea/RT}``, harmonic
    ``k_max`` cap) under a linear-ramp temperature profile, from the
    per-reaction host arrays of a ``KPMCollisionCalculator``."""
    Ea, mu, sigma, rho = (np.asarray(x, float) for x in (Ea, mu, sigma, rho))
    T0, rate, T_end = (float(profile.X_start), float(profile.rate),
                       float(profile.X_end))
    t_ramp_end = float(profile.t_end)

    def k_of_t(t):
        T = T0 + rate * t if t <= t_ramp_end else T_end
        A = sigma * rho * constants.N_A * np.sqrt(
            8.0 * constants.k_b * T / (np.pi * mu)) * 1e3
        k = A * np.exp(-Ea / (constants.R * T)) * t_mult
        if k_max is not None:
            k = 1.0 / (1.0 / k_max + 1.0 / k)
        return k

    return k_of_t


def scipy_bdf_trajectory(sd, rd, k_of_t, ts, u0, rtol, atol):
    """Continuous-rate scipy BDF under ``k_of_t`` read at the times ``ts``
    (the first at the start), restarting at each, as a chunkwise solve
    restarts at every chunk: a (len(ts), ns) array."""
    from scipy.integrate import solve_ivp

    rhs_f, jac_f = build_numpy_mass_action(sd, rd)
    rhs, jac = rhs_f(k_of_t), jac_f(k_of_t)
    ts = np.asarray(ts, float)
    out = [np.asarray(u0, float)]
    for a, b in zip(ts[:-1], ts[1:]):
        sol = solve_ivp(rhs, (a, b), out[-1], method="BDF", jac=jac,
                        rtol=rtol, atol=atol)
        assert sol.success, f"CPU baseline failed on [{a}, {b}]"
        out.append(sol.y[:, -1])
    return np.stack(out)


def scipy_bdf_chunked_baseline(sd, rd, calc, profile, tspan, u0, rtol, atol,
                               n_chunks: int = 40, best_of: int = 3):
    """Chunkwise-local-time scipy BDF — the reference's long-timescale
    formalism on CPU; returns ``(best_seconds, final_y)``.

    A plain global-time BDF cannot finish long stiff horizons: once
    t ~ 1e5 the required h drops below eps*t (scipy aborts with
    "Required step size is less than spacing between numbers" — measured
    at t ~ 6e4 on the 1095-reaction north-star ramp). The reference
    solves this by integrating each chunk in LOCAL time
    (implementation-details.md:28); this baseline does the same so the
    CPU side competes under its own best formalism.
    """
    import time

    from scipy.integrate import solve_ivp

    rhs_f, jac_f = build_numpy_mass_action(sd, rd)
    k_of_t = arrhenius_k_of_t(calc, profile)
    t_lo, t_hi = float(tspan[0]), float(tspan[1])
    chunkstep = (t_hi - t_lo) / n_chunks
    dt_best = float("inf")
    for _ in range(best_of):
        u = np.asarray(u0, float)
        t0 = time.perf_counter()
        for c in range(n_chunks):
            off = t_lo + c * chunkstep
            k_local = (lambda off: lambda t: k_of_t(off + t))(off)
            sol = solve_ivp(rhs_f(k_local), (0.0, chunkstep), u,
                            method="BDF", jac=jac_f(k_local),
                            rtol=rtol, atol=atol)
            assert sol.success, f"CPU chunked baseline failed at chunk {c}"
            u = sol.y[:, -1]
        dt_best = min(dt_best, time.perf_counter() - t0)
    return dt_best, u
