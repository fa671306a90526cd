"""Variable-order BDF(1-5) stiff integrator, batched over lanes, in PyTorch.

Counterpart of ``kinetica_tpu/ops/bdf.py``. The reference writes one
solve as a ``lax.while_loop`` and batches it with ``vmap``, which runs the
loop while any lane runs and masks each lane's carry. Here the batch is
explicit: every state field is a (B, ...) tensor, every step computes all
lanes and merges the result into the lanes that are running, so each lane
follows exactly the reference's per-lane algorithm:

* variable step and order, backward-difference array D padded to
  MAX_ORDER + 3 rows, predictor / Newton corrector / error test;
* the lazy Newton-matrix policy: the factor is rebuilt only on lanes whose
  c = h / alpha drifted by more than ``lu_drift_tol`` (gated to those
  lanes, :func:`~kinetica_tpu_torch.ops.linalg.newton_factor`), and J is
  refreshed on the lanes whose Newton iteration failed on a stale
  Jacobian (evaluated on the whole batch: the reference's lane-compacted
  refresh measured no faster on the H100); the optional
  ``jac_policy="always"`` rebuilds J and the factor at every step attempt;
* the Newton-failure step ceiling ``h_ncf``, the growth hold after a
  failure (``bruised``), the noise-floor acceptance ``_NOISE_ACCEPT``,
  the nonnegative projection and the status codes;
* stops that no step straddles, dense output at ``saveat``;
* async-chunk mode (``chunks=``): consecutive chunk-local-time segments
  in one loop, each lane advancing to its next chunk on its own;
* the warm start of a segmented solve (``first_step``, ``warm_start``):
  a segment resumes the previous one's step size and method state;
* the state dtype of ``y0`` (f64, or f32 for ``dtype="float32"``
  solves), with time and step size in f64 either way.

The loop is driven from the host. Its decisions that need device values
(any lane running, which lanes refactor, whether Newton iterations are
left, whether J needs a refresh) go through
:mod:`kinetica_tpu_torch.ops.host_sync`, which counts them. The rest of a
step is branch-free tensor arithmetic on all lanes.

The step's tail (:func:`_step_tail`: the error test, step-size and order
control, dense output, the state merge and the chunk transition) reads
nothing back to the host and its shapes are fixed within a solve. On a
CUDA device it is captured once per :func:`tail_key` into a CUDA graph
(:class:`_TailGraph`) and replayed at every step, the same kernels in the
same order, so the host launches one graph in place of a few hundred
small kernels; :func:`graph_refusal` says when the eager path runs
instead (the CPU, forward-mode tangents, inputs that require grad).

Its phases are spans of :mod:`kinetica_tpu_torch.utils.profiling`
(``bdf.solve``, ``bdf.init``, ``bdf.step``, ``bdf.predict``,
``bdf.newton``, ``bdf.newton_iter``, ``bdf.jac_refresh``,
``bdf.control``, ``bdf.chunk_transition``; ``bdf.tail`` around a
graph's input copies and replay), and ``newton_iters`` counts the
batch's Newton iterations, ``tail_replays`` the steps whose tail ran
from a graph and ``tail_captures`` the graphs captured.

Not ported: the in-carry debug trace.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..precision import assert_precision_policy
from ..utils.profiling import span, spanned
from . import host_sync
from .jvp import has_tangent, merge_dual, tangent_of
from .linalg import (NewtonFactors, lu_precision_dtype, newton_factor,
                     newton_solve, resolve_linsolve)

MAX_ORDER = 5
NEWTON_MAXITER = 4
MIN_FACTOR = 0.2
MAX_FACTOR = 10.0
_NOISE_ACCEPT = 0.03  # scaled-units Newton noise-floor acceptance threshold

# since the last reset (a run reports them): the batch's stale-J
# refreshes, its Newton iterations (each runs the RHS and the Newton
# solve on every lane), the steps whose tail ran from a CUDA graph, and
# the graphs captured; the entries' lanes' steps and rejected attempts
# (:func:`count_lanes`)
jac_refreshes = 0
newton_iters = 0
tail_replays = 0
tail_captures = 0
lane_steps = 0
rejected = 0

# the captured tails by key, least recently used first: at most
# MAX_TAIL_GRAPHS of them and MAX_TAIL_BYTES of static state (a graph's
# pool of intermediates scales with it), the newest kept whatever its size
MAX_TAIL_GRAPHS = 4
MAX_TAIL_BYTES = 256 << 20
_tail_graphs: OrderedDict = OrderedDict()
# one capture stream a device, for every capture: cuBLAS keeps a workspace
# for each stream it runs on, for the life of the process
_capture_streams: dict = {}

# Status codes
RUNNING = 0
DONE = 1
FAIL_MAX_STEPS = -1
FAIL_H_UNDERFLOW = -2

F32 = torch.float32
F64 = torch.float64
_TINY32 = torch.finfo(F32).tiny
_MAX32 = torch.finfo(F32).max


def count_lanes(n_steps, n_rejected) -> None:
    """Add a solve's per-lane ``n_steps`` and ``n_rejected`` (error-test
    rejections and Newton failures), host arrays or ints an entry already
    holds, to ``lane_steps`` and ``rejected``."""
    global lane_steps, rejected
    lane_steps += int(np.sum(n_steps))
    rejected += int(np.sum(n_rejected))


def time_dtype(state_dtype) -> torch.dtype:
    """The dtype :func:`bdf_solve` carries time quantities (t, h, stops) in:
    f64 for every state dtype. An f32 time would cap the resolvable step
    ratio at h / t ~ 1e-7. A caller that carries ``BDFResults.h`` across
    chunkwise segments starts its carry in this dtype."""
    return F64


class BDFResults(NamedTuple):
    ys: torch.Tensor          # (B, n_save, ns), or (B, chunks, n_save, ns)
    status: torch.Tensor
    t: torch.Tensor
    y_final: torch.Tensor
    h: torch.Tensor
    order: torch.Tensor
    n_steps: torch.Tensor
    n_accepted: torch.Tensor
    n_rejected: torch.Tensor
    n_fev: torch.Tensor
    n_jev: torch.Tensor
    n_lu: torch.Tensor
    D: torch.Tensor
    n_equal_steps: torch.Tensor
    # the reference's in-carry attempt log: not recorded, None as in the
    # reference's default
    trace: torch.Tensor | None = None


def _rms_norm(x: torch.Tensor) -> torch.Tensor:
    """Per-lane RMS norm in f32, inputs clipped at 1e16 (controller use)."""
    x = torch.clamp(x.to(F32), -1e16, 1e16)
    return torch.sqrt(torch.mean(x * x, dim=-1))


def _rms_norm_f64(x: torch.Tensor) -> torch.Tensor:
    """Per-lane RMS norm at full precision, scale-invariant form."""
    m = x.abs().amax(dim=-1)
    m_safe = torch.where(m > 0.0, m, torch.ones_like(m))
    return m * torch.sqrt(torch.mean((x / m_safe[:, None]) ** 2, dim=-1))


def _scaled_norm(v: torch.Tensor, scale32: torch.Tensor) -> torch.Tensor:
    return _rms_norm(v.to(F32) / scale32)


def _compute_R(factor: torch.Tensor) -> torch.Tensor:
    """(B, 6, 6) rescaling matrices R[i, j] = prod_{m=1..i}(m-1-factor*j)/m."""
    n = MAX_ORDER + 1
    ar = torch.arange(1, n, dtype=factor.dtype, device=factor.device)
    body = (ar[:, None] - 1 - factor[:, None, None] * ar[None, :]) / ar[:, None]
    M = torch.zeros(factor.shape[0], n, n, dtype=factor.dtype,
                    device=factor.device)
    M[:, 1:, 1:] = body
    M[:, 0, :] = 1.0
    return torch.cumprod(M, dim=1)


def _change_D(D: torch.Tensor, order: torch.Tensor,
              factor: torch.Tensor) -> torch.Tensor:
    """Rescale D[:, :order+1] of each lane for a step-size change by ``factor``."""
    n = MAX_ORDER + 1
    RU = _compute_R(factor.to(D.dtype)) @ _compute_R(torch.ones_like(factor,
                                                                     dtype=D.dtype))
    idx = torch.arange(n, device=D.device)
    o = order[:, None, None]
    active = (idx[None, :, None] <= o) & (idx[None, None, :] <= o)
    RU_m = torch.where(active, RU, torch.eye(n, dtype=D.dtype, device=D.device))
    Dn = torch.einsum("bkj,bkn->bjn", RU_m, D[:, :n])
    return torch.cat([Dn, D[:, n:]], dim=1)


def _bdf_constants(dtype, device):
    kappa = torch.tensor([0.0, -0.1850, -1.0 / 9.0, -0.0823, -0.0415, 0.0],
                         dtype=dtype, device=device)
    inv = 1.0 / torch.arange(1, MAX_ORDER + 1, dtype=dtype, device=device)
    gamma = torch.cat([torch.zeros(1, dtype=dtype, device=device),
                       torch.cumsum(inv, 0)])
    alpha = (1.0 - kappa) * gamma
    error_const = kappa * gamma + 1.0 / torch.arange(
        1, MAX_ORDER + 2, dtype=dtype, device=device)
    return kappa, gamma, alpha, error_const


def select_initial_step(rhs, pre, t0, y0, f0, tf, rtol, atol):
    """Hairer-style automatic initial step size, per lane (in
    :func:`time_dtype`)."""
    tdt = time_dtype(y0.dtype)
    scale = atol[:, None] + y0.abs() * rtol[:, None]
    d0 = _rms_norm_f64(y0 / scale).to(tdt)
    d1 = _rms_norm_f64(f0 / scale).to(tdt)
    span = abs(tf - float(t0[0]))
    h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5),
                     torch.full_like(d0, 1e-6), 0.01 * d0 / d1)
    h0 = torch.clamp(h0, max=span)
    h0 = torch.clamp(h0, min=torch.finfo(y0.dtype).tiny * 1e3)
    y1 = y0 + h0.to(y0.dtype)[:, None] * f0
    f1 = rhs(t0 + h0, y1, pre)
    d2 = _rms_norm_f64((f1 - f0) / scale).to(tdt) / h0
    dm = torch.maximum(d1, d2)
    h1 = torch.where(dm <= 1e-15, torch.clamp(h0 * 1e-3, min=1e-6),
                     (0.01 / dm) ** 0.5)
    return torch.minimum(100 * h0, torch.clamp(h1, max=span))


class _State:
    """The integrator state of all lanes (every field is (B, ...))."""

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)

    def merge(self, mask: torch.Tensor, **new) -> None:
        """Set the given fields to ``new`` on the lanes where ``mask`` holds."""
        for k, v in new.items():
            old = getattr(self, k)
            m = mask.reshape(mask.shape + (1,) * (old.ndim - 1))
            setattr(self, k, torch.where(m, v, old))


# the state's factor fields: the step merges them eagerly, as the tail
# reads none of them
_FACTORS = ("lu", "piv", "J")


class _Solve(NamedTuple):
    """What the step's tail reads that one solve fixes: its Python values,
    its tensors (``atol``, ``rtol``, ``saveat``, ``row_ptr0``), and
    constants of its shapes."""
    tf: float
    t0: float
    tol_t: float
    max_steps: int
    nonnegative: bool
    nonnegative_project: bool
    chunks: int | None        # None: not chunked
    n_row: int                # stops a chunk's row holds (chunked)
    save_ptr0: int
    atol: torch.Tensor        # (B,), state dtype
    rtol: torch.Tensor
    saveat: torch.Tensor      # (n_save,), time dtype
    row_ptr0: torch.Tensor | None  # (B, chunks): each chunk's first stop
    error_const32: torch.Tensor
    lanes: torch.Tensor
    idx8: torch.Tensor
    k5: torch.Tensor
    jsave: torch.Tensor


# the tensors of a solve, copied into a graph's static inputs at each
# solve; the constants of its shapes, copied once
_SOLVE_TENSORS = ("atol", "rtol", "saveat", "row_ptr0")
_SHAPE_TENSORS = ("error_const32", "lanes", "idx8", "k5", "jsave")


class _Step(NamedTuple):
    """A step attempt's values that the tail reads, each (B, ...): the
    predictor's, the factor's and the Newton iteration's."""
    run: torch.Tensor
    h_min: torch.Tensor
    clamp: torch.Tensor
    h: torch.Tensor
    D: torch.Tensor
    n_equal_steps: torch.Tensor
    t_new: torch.Tensor
    y_pred: torch.Tensor
    next_stop: torch.Tensor
    n_it: torch.Tensor
    converged: torch.Tensor
    d: torch.Tensor
    y_new: torch.Tensor
    refresh: torch.Tensor
    current_jac: torch.Tensor
    c_lu_next: torch.Tensor
    n_jev: torch.Tensor
    n_lu: torch.Tensor


def tail_key(cx: _Solve, ns: int) -> tuple:
    """The key of a captured tail: the shapes, the state dtype and the
    device, and every Python value the tail reads. Solves that differ in
    their tensors alone share a key."""
    return (cx.atol.device, cx.atol.shape[0], ns, cx.saveat.shape[0],
            cx.atol.dtype, cx.chunks, cx.tf, cx.t0, cx.tol_t, cx.max_steps,
            cx.nonnegative, cx.nonnegative_project, cx.n_row, cx.save_ptr0)


def graph_refusal(tensors) -> str | None:
    """Why the step's tail of a solve whose initial state holds
    ``tensors`` may not run from a CUDA graph, or None where it may. The
    inputs (``y0``, ``args`` through ``rhs`` and ``prepare``,
    ``first_step``, ``warm_start``) all reach the initial state, so a
    tangent or a grad among them shows there. A graph's static buffers
    would drop a forward-mode tangent and cut autograd's record, so
    those solves run eagerly, as do solves off the card and inside
    another capture."""
    if has_tangent(*tensors):
        return "a forward-mode tangent"
    if torch.is_grad_enabled() and any(x.requires_grad for x in tensors):
        return "an input requires grad"
    if not all(x.is_cuda for x in tensors):
        return "not on a CUDA device"
    with torch.cuda.device(tensors[0].device):
        if torch.cuda.is_current_stream_capturing():
            return "a capture is under way"
    return None


def _static_bytes(fields: dict) -> int:
    """The bytes of the state's fields that a graph keeps static copies of."""
    return sum(v.nbytes for k, v in fields.items() if k not in _FACTORS)


def _tail_graph(key, nbytes: int) -> "_TailGraph | None":
    """The cache's tail for ``key``, made if new, or None while a solve
    holds it (a solve nested in another's callbacks runs eagerly). The
    least recently used make room first, for a new tail of ``nbytes``
    of static state."""
    g = _tail_graphs.pop(key, None) or _TailGraph()
    while _tail_graphs and (
            len(_tail_graphs) >= MAX_TAIL_GRAPHS
            or nbytes + sum(x.nbytes for x in _tail_graphs.values())
            > MAX_TAIL_BYTES):
        _tail_graphs.popitem(last=False)
    _tail_graphs[key] = g
    return None if g.bound else g


class _TailGraph:
    """The step's tail captured once for one :func:`tail_key` and replayed
    at every step of every solve with that key.

    It owns static copies of what the tail reads: the state's fields but
    the factor's (``_FACTORS``), a step's values (:class:`_Step`) and a
    solve's tensors (:class:`_Solve`). While a solve is bound, its state
    lives in the static fields: the predictor and the Newton iteration
    read them, and the graph's merge writes them. Captured at its first
    replay, on the state's device, where it replays whatever device is
    current."""

    def __init__(self):
        self.cx = self.state = self.step = self.run = self.graph = None
        self.bound = False
        self.nbytes = 0

    def bind(self, s: _State, cx: _Solve) -> None:
        """Start a solve: its tensors and initial state into the static
        buffers, and its state object onto them."""
        if self.cx is None:
            self.cx = cx._replace(**{k: getattr(cx, k).clone()
                                     for k in _SOLVE_TENSORS + _SHAPE_TENSORS
                                     if getattr(cx, k) is not None})
            self.state = {k: v.clone() for k, v in vars(s).items()
                          if k not in _FACTORS}
            self.nbytes = _static_bytes(self.state)
        else:
            for k in _SOLVE_TENSORS:
                if getattr(cx, k) is not None:
                    getattr(self.cx, k).copy_(getattr(cx, k))
            for k, v in self.state.items():
                v.copy_(getattr(s, k))
        for k, v in self.state.items():
            setattr(s, k, v)
        self.bound = True

    def unbind(self, s: _State) -> None:
        """End a solve: its state object onto copies of the static fields,
        which the next replay overwrites."""
        for k, v in self.state.items():
            setattr(s, k, v.clone())
        self.bound = False

    def replay(self, st: _Step) -> None:
        """Run the tail of one step: its values into the static inputs,
        then the graph (captured first if it is not yet)."""
        global tail_replays, tail_captures
        if self.step is None:
            self.step = _Step(*(torch.empty_like(v) for v in st))
        for dst, src in zip(self.step, st):
            dst.copy_(src)
        if self.run is None:
            self._capture()
            tail_captures += 1
        self.run()
        tail_replays += 1

    def _tail(self) -> Callable[[], None]:
        """The tail on the static buffers, merging into them in place."""
        state, step, cx = self.state, self.step, self.cx

        def tail():
            s = _State(**state)
            _step_tail(s, step, cx)
            for k, v in state.items():
                new = getattr(s, k)
                if new is not v:
                    v.copy_(new)
        return tail

    def _capture(self) -> None:
        """Capture the tail into a CUDA graph; ``run`` replays it."""
        dev = self.state["t"].device
        tail = self._tail()
        with torch.cuda.device(dev):
            stream = _capture_streams.get(dev.index)
            if stream is None:
                stream = _capture_streams[dev.index] = torch.cuda.Stream(dev)
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                # warm-up on the capture stream (cuBLAS's workspace); its
                # merge rebinds a throwaway state, so the static fields stay
                _step_tail(_State(**self.state), self.step, self.cx)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=stream,
                                  capture_error_mode="thread_local"):
                tail()

        def replay():
            with torch.cuda.device(dev):
                graph.replay()
        self.graph, self.run = graph, replay


def _safe_factor(factor, fallback):
    ok = torch.isfinite(factor) & (factor > 0.0)
    return torch.where(ok, factor, torch.full_like(factor, fallback))


def _err_factor(err, inv_q):
    base = torch.clamp(err, _TINY32 * 1e3, _MAX32 / 1e3)
    f = base ** (-inv_q)
    f = torch.where(err <= 0.0, torch.full_like(f, MAX_FACTOR), f)
    return torch.where(torch.isfinite(err), f, torch.zeros_like(f))


def _fill_saveat(cx: _Solve, t_new, h, order, D, save_ptr, ys):
    """Dense output at the saveat points in (t_prev, t_new]."""
    k5, saveat = cx.k5, cx.saveat
    t_shift = t_new[:, None] - h[:, None] * k5
    denom = h[:, None] * (1.0 + k5)
    x = (saveat[None, :, None] - t_shift[:, None, :]) / denom[:, None, :]
    p = torch.cumprod(x, dim=-1)
    p = torch.where(k5[None, None, :] < order[:, None, None], p,
                    torch.zeros_like(p))
    yq = D[:, None, 0] + torch.einsum("bsk,bkn->bsn", p.to(D.dtype),
                                      D[:, 1:MAX_ORDER + 1])
    hit = ((cx.jsave[None, :] >= save_ptr[:, None])
           & (saveat[None, :] <= (t_new + cx.tol_t)[:, None]))
    return (save_ptr + hit.sum(dim=1),
            torch.where(hit[:, :, None], yq, ys))


def _dump_chunk(s: _State, mask, chunks: int) -> None:
    """ys_all[b, nc[b]] = ys[b] on the lanes in ``mask``."""
    sel = mask[:, None] & (torch.arange(chunks, device=mask.device)[None, :]
                           == s.nc[:, None])
    s.ys_all = torch.where(sel[:, :, None, None], s.ys[:, None], s.ys_all)


def _step_tail(s: _State, st: _Step, cx: _Solve) -> None:
    """The step's tail: the error test, order and step-size control, dense
    output and the merge of the outcome into the running lanes' state,
    then (chunked) the chunk transition. It reads no device value on the
    host and its shapes are fixed by the key (:func:`tail_key`), so a CUDA
    graph can hold it (:class:`_TailGraph`); called as it is, it is the
    eager path."""
    run, h, D, converged, d, y_new = (st.run, st.h, st.D, st.converged,
                                      st.d, st.y_new)
    clamp, refresh, n_it = st.clamp, st.refresh, st.n_it
    n_equal_steps, t_new = st.n_equal_steps, st.t_new
    t, h_pre, order = s.t, s.h, s.order
    lanes, error_const32 = cx.lanes, cx.error_const32
    rows = cx.idx8[None, :, None]
    o3 = order[:, None, None]
    with span("bdf.control"):
        safety = (0.9 * (2 * NEWTON_MAXITER + 1)
                  / (2 * NEWTON_MAXITER + n_it.to(F32)))

        # --- error test (norms in f32, d in the state dtype) ---
        scale_full = (cx.atol[:, None] + cx.rtol[:, None]
                      * torch.clamp(y_new.abs(), max=1e37))
        err_norm = _rms_norm(error_const32[order][:, None]
                             * (d / scale_full).to(F32))
        neg = (torch.full_like(converged, cx.nonnegative)
               & (y_new.amin(dim=1) < 0.0))
        accept = converged & (err_norm <= 1.0) & ~neg

        # --- accept path: differences, dense output, order adaptation ---
        n_eq_acc = n_equal_steps + 1
        d_proj = (torch.clamp(y_new, min=0.0) - st.y_pred
                  if cx.nonnegative_project else d)
        selq = rows == (o3 + 1)
        Dq1 = torch.where(selq, D, torch.zeros_like(D)).sum(dim=1)
        D_mid = torch.where(selq, d_proj[:, None],
                            torch.where(rows == o3 + 2, (d_proj - Dq1)[:, None],
                                        D))
        contrib = torch.where(rows <= o3 + 1, D_mid, torch.zeros_like(D_mid))
        suffix = contrib.flip(1).cumsum(dim=1).flip(1)
        D2 = torch.where(rows <= o3, suffix, D_mid)
        save_ptr2, ys2 = _fill_saveat(cx, t_new, h, order, D2, s.save_ptr,
                                      s.ys)
        done = t_new >= cx.tf - cx.tol_t
        hit_stop = (t_new - st.next_stop).abs() <= cx.tol_t

        od = order.to(F32)
        err_m = torch.where(
            order > 1,
            _rms_norm(error_const32[torch.clamp(order - 1, min=0)][:, None]
                      * (D2[lanes, order] / scale_full).to(F32)),
            torch.full_like(err_norm, float("inf")))
        err_p = torch.where(
            order < MAX_ORDER,
            _rms_norm(error_const32[torch.clamp(order + 1, max=MAX_ORDER)][:, None]
                      * (D2[lanes, order + 2] / scale_full).to(F32)),
            torch.full_like(err_norm, float("inf")))
        factors = torch.stack([_err_factor(err_m, 1.0 / od),
                               _err_factor(err_norm, 1.0 / (od + 1)),
                               _err_factor(err_p, 1.0 / (od + 2))], dim=1)
        best = torch.argmax(factors, dim=1)
        do_adapt = (n_eq_acc >= order + 1) & ~clamp
        new_order = torch.where(do_adapt,
                                torch.clamp(order + best - 1, 1, MAX_ORDER),
                                order)
        factor_acc = torch.where(
            do_adapt,
            torch.clamp(safety * factors[lanes, best], MIN_FACTOR, MAX_FACTOR),
            torch.ones_like(safety))
        factor_acc = _safe_factor(factor_acc, 1.0)
        # hold h on the first accepted step after a Newton failure
        factor_acc = torch.where(s.bruised, torch.clamp(factor_acc, max=1.0),
                                 factor_acc)
        # Newton-failure ceiling, relaxing x1.5 per accepted step
        ncf_cap = torch.where(
            torch.isfinite(s.h_ncf),
            torch.clamp(torch.clamp(0.9 * s.h_ncf / h, max=1e30).to(F32),
                        min=1.0),
            torch.full_like(factor_acc, MAX_FACTOR))
        factor_acc = torch.minimum(factor_acc, _safe_factor(ncf_cap, MAX_FACTOR))
        # after a clamped step restore the pre-clamp h (overrides the caps)
        factor_acc = torch.where(
            clamp,
            _safe_factor(torch.clamp(h_pre / h, max=MAX_FACTOR).to(F32), 1.0),
            factor_acc)
        rescale_acc = clamp | do_adapt

        factor_rej = _safe_factor(
            torch.clamp(safety * err_norm ** (-1.0 / (od + 1)), MIN_FACTOR, 1.0),
            MIN_FACTOR)
        factor_rej = torch.where(neg, torch.clamp(factor_rej, max=0.5),
                                 factor_rej)

        # outcome: accept | error-reject | jac-refresh | newton-fail
        reject = converged & ~accept
        nfail = ~converged & ~refresh
        order_next = torch.where(accept, new_order, order)
        factor = torch.where(
            accept, factor_acc.to(h.dtype),
            torch.where(reject, factor_rej.to(h.dtype),
                        torch.where(nfail, torch.full_like(h, 0.5),
                                    torch.ones_like(h))))
        rescale = torch.where(accept, rescale_acc, reject | nfail)
        D_base = torch.where(accept[:, None, None], D2, D)
        D_next = torch.where(rescale[:, None, None],
                             _change_D(D_base, order_next, factor), D_base)
        h_next = torch.where(rescale, h * factor, h)
        n_eq_next = torch.where(
            accept, torch.where(rescale_acc, 0, n_eq_acc),
            torch.where(refresh, n_equal_steps, 0))
        t_next = torch.where(accept, t_new, t)
        n_steps = s.n_steps + 1
        status = torch.where(accept & done, DONE, s.status)
        # NaN/inf in h or t never recovers: fail the lane at once
        h_under = (h_next < st.h_min) | ~(torch.isfinite(h_next)
                                          & torch.isfinite(t_next))
        status = torch.where(
            status == DONE, DONE,
            torch.where(n_steps >= cx.max_steps, FAIL_MAX_STEPS,
                        torch.where(h_under, FAIL_H_UNDERFLOW, RUNNING)))
        s.merge(
            run, t=t_next, h=h_next, order=order_next, D=D_next,
            n_equal_steps=n_eq_next, c_lu=st.c_lu_next,
            current_jac=st.current_jac & ~accept, status=status,
            n_accepted=s.n_accepted + accept.long(),
            n_rejected=s.n_rejected + (reject | nfail).long(),
            save_ptr=torch.where(accept, save_ptr2, s.save_ptr),
            ys=torch.where(accept[:, None, None], ys2, s.ys),
            stop_ptr=torch.where(accept, s.stop_ptr + hit_stop.long(),
                                 s.stop_ptr),
            n_jev=st.n_jev, n_lu=st.n_lu, n_fev=s.n_fev + n_it,
            n_steps=n_steps,
            bruised=torch.where(accept, False, s.bruised | nfail),
            h_ncf=torch.where(nfail & ~clamp, h,
                              torch.where(accept, s.h_ncf * 1.5, s.h_ncf)))
    if cx.chunks is not None:
        _chunk_transition(s, cx)


@spanned("bdf.chunk_transition")
def _chunk_transition(s: _State, cx: _Solve) -> None:
    """Lanes that finished a chunk (not the last) start the next one."""
    chunks = cx.chunks
    trans = (s.status == DONE) & (s.nc < chunks - 1)
    _dump_chunk(s, trans, chunks)
    nc2 = s.nc + 1
    h2 = torch.clamp(s.h, max=cx.tf - cx.t0)
    shrink = h2 < s.h
    D2 = torch.where(shrink[:, None, None],
                     _change_D(s.D, s.order,
                               torch.where(shrink, h2 / s.h,
                                           torch.ones_like(h2))), s.D)
    stop_ptr2 = (nc2 * cx.n_row
                 + cx.row_ptr0[cx.lanes, torch.clamp(nc2, max=chunks - 1)])
    s.merge(trans, t=torch.full_like(s.t, cx.t0), h=h2, D=D2, nc=nc2,
            ys=torch.zeros_like(s.ys),
            save_ptr=torch.full_like(s.save_ptr, cx.save_ptr0),
            stop_ptr=stop_ptr2, status=torch.full_like(s.status, RUNNING),
            n_equal_steps=torch.where(shrink, 0, s.n_equal_steps))


@spanned("bdf.solve")
def bdf_solve(rhs: Callable, jac: Callable, y0: torch.Tensor, t0: float,
              tf: float, saveat, rtol=1e-8, atol=1e-10, stops=None,
              max_steps: int = 100000, first_step=None,
              nonnegative: bool = False, nonnegative_project: bool = False,
              lu_precision: str = "mixed", refine: int = 1,
              linsolve: str = "auto", jac_policy: str = "lazy",
              lu_drift_tol: float = 0.1, prepare: Callable | None = None,
              warm_start=None, args=None, chunks: int | None = None,
              chunk_offsets=None,
              on_chunk: Callable | None = None) -> BDFResults:
    """Integrate ``dy/dt = rhs(t, y, pre)`` for a batch of lanes with BDF(1-5).

    The parameters are the reference's, in its order; ``on_chunk`` is the
    port's own.

    Args:
      rhs: ``(t (B,), y (B, ns), pre) -> (B, ns)``.
      jac: ``(t, y, pre) -> (B, ns, ns)``; its dtype is the Newton
        Jacobian's (f32 on the main path).
      y0: (B, ns) initial states; their dtype is the state dtype (f64 or
        f32; "inv_fused" takes f64 only).
      t0, tf: the integration window (floats; chunk-local in chunk mode).
      saveat: increasing times in (t0, tf] to record; entries <= t0 are
        skipped.
      rtol, atol: floats or (B,) per-lane tolerances.
      stops: sorted event times padded with +inf, (n,) or (B, n); no step
        straddles one. In chunk mode (chunks, n) or (B, chunks, n) rows
        in chunk-local time.
      prepare: ``(t_stage, t_step_start, a) -> pre``, run once per step
        attempt (the rate constants of the step); ``a`` is ``args``, or
        ``(chunk_offsets[nc], args)`` in chunk mode. Without it ``pre``
        is ``args``.
      lu_precision: "mixed" (the default: the f32 inverse of the inverse
        methods; "lu" is an f64 LU either way, as the reference's CPU
        promotes "mixed") or "full", which needs ``linsolve="lu"`` and
        raises ``ValueError`` otherwise (the inverses are f32 only).
      refine: the mandatory refinement sweeps of a Newton solve, passed to
        :func:`~kinetica_tpu_torch.ops.linalg.newton_solve`: "inv" and
        "inv_gated" run a fixed two sweeps whatever its value (the
        reference's accelerator schedule), "inv_fused" one mandatory sweep
        and adaptive ones, up to four in all, in its kernel, and the f64
        "lu" factor none.
      linsolve: the Newton linear solve, "auto" (the default: "inv_gated"
        up to 512 species, "lu" above), "inv", "inv_gated", "inv_fused"
        or "lu" (:mod:`.linalg`).
      jac_policy: "lazy" (J refreshed after a Newton failure on a stale J,
        the factor rebuilt when c drifts) or "always" (J and the factor
        rebuilt at every step attempt).
      chunks: async-chunk mode — integrate ``chunks`` consecutive segments
        of [t0, tf] in chunk-local time in one loop; each lane moves to its
        next chunk as it finishes one, carrying its method state (D, order,
        h, J, factor, h_ncf). ``ys`` gains a chunk axis and ``max_steps``
        bounds the total over all chunks.
      first_step: (B,) step size to start with (a segment carries the
        previous segment's final ``h``); a lane whose value is not finite
        and positive takes the automatic initial step. It is clamped to
        the window ``tf - t0``.
      warm_start: ``(D, order, n_equal_steps)`` of the previous segment's
        results. A lane with a valid ``first_step`` and ``order >= 1``
        resumes that method state (D rescaled to the clamped first step,
        row 0 replaced by ``y0``) instead of restarting at order 1; the
        others start cold. J and the factor are rebuilt at the start
        either way.
      on_chunk: chunk mode only: called as ``on_chunk(nc)`` with the
        lowest chunk index of the running lanes (``chunks`` once none
        runs) after every step. It comes with the loop's one read of the
        running mask, so it costs no device-to-host read of its own.
    """
    assert_precision_policy()
    if jac_policy not in ("lazy", "always"):
        raise ValueError(f"unknown jac_policy {jac_policy!r}")
    dev, dtype = y0.device, y0.dtype
    B, ns = y0.shape
    linsolve = resolve_linsolve(linsolve, ns)
    lu_dtype = lu_precision_dtype(lu_precision, linsolve, dtype)
    if linsolve == "inv_fused" and dtype != F64:
        raise ValueError(f"linsolve='inv_fused' needs an f64 state (its "
                         f"kernel carries b and dy in f64), got {dtype}; "
                         f"use 'inv_gated' or 'auto'")
    if linsolve == "inv_fused":
        # the Newton-solve kernel reads J row-major: lay J out so once, where
        # it is evaluated, not at every solve
        jac_eval = jac

        def jac(t, y, pre):
            return jac_eval(t, y, pre).contiguous()
    chunked = chunks is not None
    if chunked and (prepare is None or chunk_offsets is None):
        raise ValueError("chunks= mode requires prepare and chunk_offsets")

    lanes = torch.arange(B, device=dev)
    tdt = time_dtype(dtype)
    f64 = dict(dtype=tdt, device=dev)
    i64 = dict(dtype=torch.int64, device=dev)
    t0, tf = float(t0), float(tf)
    rtol = torch.as_tensor(rtol, dtype=dtype, device=dev).expand(B).clone()
    atol = torch.as_tensor(atol, dtype=dtype, device=dev).expand(B).clone()
    saveat = torch.as_tensor(saveat, **f64).reshape(-1)
    n_save = saveat.shape[0]
    eps = torch.finfo(tdt).eps
    tspan_scale = max(abs(tf), 1.0)
    tol_t = 4 * eps * tspan_scale

    if chunked:
        if stops is None:
            stops = torch.full((chunks, 1), float("inf"), **f64)
        stops = torch.as_tensor(stops, **f64)
        if stops.ndim == 2:
            stops = stops.expand(B, *stops.shape)
        if stops.ndim != 3 or stops.shape[:2] != (B, chunks):
            raise ValueError("chunked stops must have shape "
                             f"(chunks, n) or ({B}, {chunks}, n)")
        # +inf guard column: a full row never leaks into the next chunk
        stops2d = torch.cat([stops, torch.full((B, chunks, 1), float("inf"),
                                               **f64)], dim=2).contiguous()
        n_row = stops2d.shape[2]
        row_ptr0 = torch.searchsorted(
            stops2d, torch.full((B, chunks, 1), t0 + tol_t, **f64)
        )[..., 0]
        stops = stops2d.reshape(B, -1)
        stop_ptr0 = row_ptr0[:, 0]
        offsets = torch.as_tensor(chunk_offsets, **f64)
    else:
        if stops is None:
            stops = torch.full((B, 1), float("inf"), **f64)
        stops = torch.as_tensor(stops, **f64)
        if stops.ndim == 1:
            stops = stops.expand(B, -1)
        stops = stops.contiguous()
        stop_ptr0 = torch.searchsorted(
            stops, torch.full((B, 1), t0 + tol_t, **f64))[:, 0]
    n_stops = stops.shape[1]

    if prepare is None:
        def prep(t_stage, t_start, nc):
            return args
    elif chunked:
        def prep(t_stage, t_start, nc):
            return prepare(t_stage, t_start,
                           (offsets[torch.clamp(nc, max=chunks - 1)], args))
    else:
        def prep(t_stage, t_start, nc):
            return prepare(t_stage, t_start, args)

    _, gamma, alpha, error_const = _bdf_constants(tdt, dev)
    error_const32 = error_const.to(F32)
    newton_tol = torch.maximum(
        10 * torch.finfo(dtype).eps / rtol,
        torch.clamp(rtol ** 0.5, max=0.03)).to(F32)
    atol32, rtol32 = atol.to(F32)[:, None], rtol.to(F32)[:, None]
    idx8 = torch.arange(MAX_ORDER + 3, device=dev)
    k5 = torch.arange(MAX_ORDER, device=dev)
    jsave = torch.arange(n_save, device=dev)
    inf = torch.full((B,), float("inf"), **f64)

    # ---- initial state ----
    with span("bdf.init"):
        t_init = torch.full((B,), t0, **f64)
        nc0 = torch.zeros(B, **i64)
        pre0 = prep(t_init, t_init, nc0)
        f0 = rhs(t_init, y0, pre0)
        h_init = select_initial_step(rhs, pre0, t_init, y0, f0, tf, rtol, atol)
        fs, fs_ok = h_init, torch.zeros(B, dtype=torch.bool, device=dev)
        if first_step is not None:
            fs = torch.as_tensor(first_step, **f64).expand(B)
            fs_ok = torch.isfinite(fs) & (fs > 0.0)
            h_init = torch.where(fs_ok, torch.clamp(fs, max=abs(tf - t0)), h_init)
        D0 = torch.zeros(B, MAX_ORDER + 3, ns, dtype=dtype, device=dev)
        D0[:, 0] = y0
        D0[:, 1] = f0 * h_init.to(dtype)[:, None]
        order0 = torch.ones(B, **i64)
        neq0 = torch.zeros(B, **i64)
        if warm_start is not None:
            D_w, order_w, neq_w = warm_start
            order_w = torch.as_tensor(order_w, **i64).expand(B)
            warm_ok = fs_ok & (order_w >= 1)
            rescale = torch.where(warm_ok, h_init / torch.where(fs_ok, fs, h_init),
                                  torch.ones_like(h_init))
            D_w = _change_D(torch.as_tensor(D_w, dtype=dtype, device=dev),
                            torch.clamp(order_w, min=1), rescale)
            D_w[:, 0] = y0
            D0 = torch.where(warm_ok[:, None, None], D_w, D0)
            order0 = torch.where(warm_ok, order_w, order0)
            neq0 = torch.where(warm_ok, torch.as_tensor(neq_w, **i64).expand(B),
                               neq0)
        J0 = jac(t_init, y0, pre0)
        c0 = h_init / alpha[order0]
        fact0 = newton_factor(J0, c0.to(dtype), lu_dtype, method=linsolve)
        save_ptr0 = int(torch.searchsorted(saveat, torch.tensor([t0], **f64),
                                           right=True)[0])
        zi = torch.zeros(B, **i64)
        s = _State(
            t=t_init, h=h_init, order=order0, D=D0, n_equal_steps=neq0,
            lu=fact0.lu, piv=fact0.piv, J=J0,
            current_jac=torch.ones(B, dtype=torch.bool, device=dev), c_lu=c0,
            status=torch.full((B,), RUNNING, **i64), n_steps=zi,
            n_accepted=zi, n_rejected=zi, n_fev=zi + 2, n_jev=zi + 1, n_lu=zi + 1,
            save_ptr=zi + save_ptr0,
            ys=torch.zeros(B, n_save, ns, dtype=dtype, device=dev),
            stop_ptr=stop_ptr0, bruised=torch.zeros(B, dtype=torch.bool, device=dev),
            h_ncf=inf.clone(), nc=nc0,
            ys_all=(torch.zeros(B, chunks, n_save, ns, dtype=dtype, device=dev)
                    if chunked else torch.zeros(B, 0, device=dev)))

    @spanned("bdf.newton")
    def newton_iterate(run, t_new, pre, y_pred, c, psi, scale, fact):
        """Simplified Newton on the running lanes: d = c f(t_new, y_pred + d) - psi.

        A dual ``y_pred`` (forward-mode tangents) iterates its tangent on
        after the primal stopped, until the tangent's update passes the
        primal's test, weighed as the primal's (atol + rtol |tangent of
        y_pred|), within ``NEWTON_MAXITER`` iterations: the primal's test
        alone stops the tangent short of its solution. The iterations
        after the primal's last move the tangent only, so the primal, its
        iteration count and its convergence are the plain solve's, bit for
        bit."""
        global newton_iters
        d = torch.zeros_like(y_pred)
        y = y_pred
        n_it = torch.zeros(B, **i64)
        converged = torch.zeros(B, dtype=torch.bool, device=dev)
        dy_last = torch.zeros(B, dtype=F32, device=dev)
        active = run
        y_t = tangent_of(y_pred)
        tangent = y_t is not None
        if tangent:
            scale_t = atol32 + rtol32 * torch.clamp(y_t.abs(), max=1e37).to(F32)
            t_last = torch.zeros(B, dtype=F32, device=dev)
            t_active = run

        def test(norm, last, it):
            """(converged, diverging) of an update of scaled norm ``norm``
            after one of ``last``."""
            small = norm < 0.03 * newton_tol
            if it == 0:
                return small | (norm == 0.0), torch.zeros_like(small)
            rate = norm / torch.clamp(last, min=_TINY32)
            conv = small | ((rate < 1.0) & (rate / (1 - rate) * norm
                                            < newton_tol))
            return conv, (~small) & (rate >= 1.2) & (~conv)

        for it in range(NEWTON_MAXITER):
            going = active | t_active if tangent else active
            # a lane needs >= 2 iterations unless its first update is tiny,
            # so the first read of the active mask comes after two
            if it >= 2 and not host_sync.any_true(going, "bdf.newton"):
                break
            newton_iters += 1
            with span("bdf.newton_iter"):
                f = rhs(t_new, y, pre)
                dy = newton_solve(fact, c[:, None] * f - psi - d,
                                  refine=refine, method=linsolve)
                dy_norm = _scaled_norm(dy, scale)
                conv, bad = test(dy_norm, dy_last, it)
                if tangent:
                    t_norm = _scaled_norm(tangent_of(dy), scale_t)
                    t_conv, t_bad = test(t_norm, t_last, it)
                    d = merge_dual(active, going, d + dy, d)
                    y = merge_dual(active, going, y + dy, y)
                    t_last = torch.where(going, t_norm, t_last)
                    # a lane's tangent goes on while the primal does, or
                    # until its own update converged (or either diverged)
                    t_active = going & ~t_conv & ~t_bad & ~(active & bad)
                else:
                    a = active[:, None]
                    d = torch.where(a, d + dy, d)
                    y = torch.where(a, y + dy, y)
                n_it = torch.where(active, it + 1, n_it)
                dy_last = torch.where(active, dy_norm, dy_last)
                converged = torch.where(active, conv, converged)
                active = active & ~conv & ~bad
        # exits whose last update sat below the noise floor count as converged
        converged = converged | ((n_it > 0) & (dy_last < _NOISE_ACCEPT))
        return converged, n_it, y, d

    def step_attempt(run):
        global jac_refreshes
        with span("bdf.predict"):
            t, h_pre, order = s.t, s.h, s.order
            # --- clamp h so no step straddles tf or the next stop ---
            h_min = t.abs() * eps * 10 + torch.finfo(tdt).tiny * 1e4
            sp = torch.clamp(s.stop_ptr, max=n_stops - 1)
            next_stop = torch.where(s.stop_ptr < n_stops, stops[lanes, sp], inf)
            t_bound = torch.clamp(next_stop, max=tf)
            clamp = (t + 1.02 * h_pre) >= (t_bound - tol_t)
            h = torch.where(clamp, torch.maximum(t_bound - t, h_min), h_pre)
            D = torch.where(clamp[:, None, None], _change_D(s.D, order, h / h_pre),
                            s.D)
            n_equal_steps = torch.where(clamp, 0, s.n_equal_steps)
            t_new = torch.where(clamp, t_bound, t + h)

            # --- predictor ---
            rows = idx8[None, :, None]
            o3 = order[:, None, None]
            y_pred = torch.where(rows <= o3, D, torch.zeros_like(D)).sum(dim=1)
            scale_pred = atol32 + rtol32 * torch.clamp(y_pred.abs(), max=1e37).to(F32)
            gsel = (idx8[None, :] >= 1) & (idx8[None, :] <= order[:, None])
            gamma_w = torch.where(gsel, gamma[torch.clamp(idx8, max=MAX_ORDER)],
                                  torch.zeros((), **f64))
            psi = (gamma_w.to(dtype)[:, :, None] * D).sum(dim=1) / \
                alpha[order].to(dtype)[:, None]
            c = h / alpha[order]
            c_state = c.to(dtype)
            pre = prep(t_new, t, s.nc)

        if jac_policy == "always":
            # J and the factor fresh at every attempt: no stale-J retry
            J = jac(t_new, y_pred, pre)
            fnew = newton_factor(J, c_state, lu_dtype, method=linsolve)
            n_lu, n_jev = s.n_lu + 1, s.n_jev + 1
            converged, n_it, y_new, d = newton_iterate(
                run, t_new, pre, y_pred, c_state, psi, scale_pred,
                NewtonFactors(lu=fnew.lu, piv=fnew.piv, J=J, c=c_state))
            refresh = torch.zeros_like(run)
            current_jac = torch.ones_like(run)
            c_lu_next = c
        else:
            # --- factor cache: refactor the lanes whose c drifted ---
            need_lu = run & ((c - s.c_lu).abs() > lu_drift_tol * c.abs())
            prev = NewtonFactors(lu=s.lu, piv=s.piv, J=s.J, c=c_state)
            fnew = newton_factor(s.J, c_state, lu_dtype, method=linsolve,
                                 need=need_lu, prev=prev)
            n_lu = s.n_lu + need_lu.long()
            fact = NewtonFactors(lu=fnew.lu, piv=fnew.piv, J=s.J, c=c_state)
            converged, n_it, y_new, d = newton_iterate(
                run, t_new, pre, y_pred, c_state, psi, scale_pred, fact)

            # Newton failed on a stale Jacobian: refresh J, redo the step next
            refresh = run & ~converged & ~s.current_jac
            J = s.J
            if host_sync.any_true(refresh, "bdf.jac_refresh"):
                jac_refreshes += 1
                with span("bdf.jac_refresh"):
                    J = torch.where(refresh[:, None, None],
                                    jac(t_new, y_pred, pre), J)
            current_jac = s.current_jac | refresh
            n_jev = s.n_jev + refresh.long()
            c_lu_next = torch.where(refresh, -inf,
                                    torch.where(need_lu, c, s.c_lu))

        s.merge(run, lu=fnew.lu, piv=fnew.piv, J=J)
        return _Step(run=run, h_min=h_min, clamp=clamp, h=h, D=D,
                     n_equal_steps=n_equal_steps, t_new=t_new, y_pred=y_pred,
                     next_stop=next_stop, n_it=n_it, converged=converged, d=d,
                     y_new=y_new, refresh=refresh, current_jac=current_jac,
                     c_lu_next=c_lu_next, n_jev=n_jev, n_lu=n_lu)

    def running():
        """The running mask and whether any lane runs (the loop's read)."""
        run = s.status == RUNNING
        if on_chunk is not None and chunked:
            going, nc_lo = host_sync.any_true_and_min(
                run, torch.where(run, s.nc, chunks), "bdf.loop")
            on_chunk(nc_lo)
            return run, going
        return run, host_sync.any_true(run, "bdf.loop")

    cx = _Solve(tf=tf, t0=t0, tol_t=tol_t, max_steps=max_steps,
                nonnegative=nonnegative,
                nonnegative_project=nonnegative_project, chunks=chunks,
                n_row=n_row if chunked else 0, save_ptr0=save_ptr0,
                atol=atol, rtol=rtol, saveat=saveat,
                row_ptr0=row_ptr0 if chunked else None,
                error_const32=error_const32, lanes=lanes, idx8=idx8, k5=k5,
                jsave=jsave)
    graph = None
    if graph_refusal(list(vars(s).values())) is None:
        graph = _tail_graph(tail_key(cx, ns), _static_bytes(vars(s)))
    if graph is not None:
        graph.bind(s, cx)
    try:
        # a step's span ends with the read that decides whether another runs
        run, going = running()
        while going:
            with span("bdf.step"):
                st = step_attempt(run)
                if graph is None:
                    _step_tail(s, st, cx)
                else:
                    with span("bdf.tail"):
                        graph.replay(st)
                run, going = running()
    finally:
        if graph is not None:
            graph.unbind(s)

    if chunked:
        # the last chunk (or the one a failed lane died in) is still local
        _dump_chunk(s, torch.ones(B, dtype=torch.bool, device=dev), chunks)
        ys_out = s.ys_all
    else:
        ys_out = s.ys
    return BDFResults(
        ys=ys_out, status=s.status, t=s.t, y_final=s.D[:, 0], h=s.h,
        order=s.order, n_steps=s.n_steps, n_accepted=s.n_accepted,
        n_rejected=s.n_rejected, n_fev=s.n_fev, n_jev=s.n_jev, n_lu=s.n_lu,
        D=s.D, n_equal_steps=s.n_equal_steps)
