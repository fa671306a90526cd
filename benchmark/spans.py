"""The program's solve record laid over the traced solve's kernels: the
shared code of the readers of the device's idle time by phase and of the
program's counters a step.

The program (``kinetica_tpu_torch.utils.profiling``) records its spans
whenever a profiler records, so the traced solve leaves one record:
spans with start and end on the profiler's clock (Unix ns), and the
deltas of its counters. A program without such records, or a record that
is not the traced solve's (its outermost span does not overlap the traced
kernels), gives no reading.

The device's idle intervals are the gaps between the traced kernels
(``Trace.kernels``: copies and sets are not kernels) inside the record's
outermost span. Each is split among the host's spans by overlap: each
piece goes to the innermost span open over it, read as its phase: one of
``PHASES``, else that of its nearest ancestor in ``PHASES``, else
``SETUP``. The five phases' idle shares of the traced window add up to
the device's idle share within the program's solve.
"""
from __future__ import annotations

PHASES = ("host_sync.read", "linalg.factor", "bdf.newton", "bdf.step")
SETUP = "setup"

_cache: dict = {}


def record(ctx):
    """The program's newest solve record, if its outermost span overlaps
    the kernels of ``ctx``'s traced solve; else None."""
    tr = ctx.trace
    if tr is None or not tr.kernels:
        return None
    try:
        from kinetica_tpu_torch.utils import profiling
    except ImportError:
        return None
    last = getattr(profiling, "last_solve", None)
    rec = last() if last is not None else None
    if rec is None or not rec.spans:
        return None
    top = rec.spans[0]
    lo = min(k.start_ns for k in tr.kernels)
    hi = max(k.start_ns + k.dur_ns for k in tr.kernels)
    if top.end_ns <= lo or top.start_ns >= hi:
        return None
    return rec


def gaps(kernels, lo: int, hi: int) -> list[tuple[int, int]]:
    """The intervals of [lo, hi] that no kernel covers, in order."""
    out, cur = [], lo
    for k in sorted(kernels, key=lambda k: k.start_ns):
        a, b = max(k.start_ns, lo), min(k.start_ns + k.dur_ns, hi)
        if b <= max(a, cur):
            continue
        if a > cur:
            out.append((cur, a))
        cur = b
    if cur < hi:
        out.append((cur, hi))
    return out


def segments(spans) -> list[tuple[int, int, str]]:
    """The outermost span's interval cut into (start, end, phase) pieces,
    in order: each piece's phase is that of the innermost span open over
    it. ``spans`` in start order, the outermost first; a span whose
    parent was dropped is left out."""
    ids = {s.id for s in spans}
    children: dict[int, list] = {}
    for s in spans[1:]:
        if s.parent in ids:
            children.setdefault(s.parent, []).append(s)
    out = []

    def cut(s, phase):
        phase = s.name if s.name in PHASES else phase
        cur = s.start_ns
        for c in children.get(s.id, ()):
            if c.start_ns > cur:
                out.append((cur, c.start_ns, phase))
            cut(c, phase)
            cur = max(cur, c.end_ns)
        if s.end_ns > cur:
            out.append((cur, s.end_ns, phase))

    cut(spans[0], SETUP)
    return out


def idle_by_phase(kernels, spans) -> dict[str, int]:
    """Idle ns of the device inside the outermost span, by phase."""
    top = spans[0]
    segs = segments(spans)
    out = dict.fromkeys(PHASES + (SETUP,), 0)
    i = 0
    for g0, g1 in gaps(kernels, top.start_ns, top.end_ns):
        while i < len(segs) and segs[i][1] <= g0:
            i += 1
        j = i
        while j < len(segs) and segs[j][0] < g1:
            a, b = max(g0, segs[j][0]), min(g1, segs[j][1])
            if b > a:
                out[segs[j][2]] += b - a
            j += 1
    return out


def idle_share(ctx, phase: str):
    """100 x the device's idle ns in ``phase`` over the traced window, or
    None without a record of the traced solve."""
    rec = record(ctx)
    if rec is None or ctx.trace.window_s <= 0:
        return None
    # the five readers of one run share one split
    of = _cache.get("of", (None, None))
    if of[0] is not ctx.trace or of[1] is not rec:
        _cache["of"] = (ctx.trace, rec)
        _cache["ns"] = idle_by_phase(ctx.trace.kernels, rec.spans)
    return 100.0 * _cache["ns"][phase] * 1e-9 / ctx.trace.window_s


def per_step(ctx, counter: str):
    """The record's ``counter`` over the traced solve's steps max, or
    None."""
    rec = record(ctx)
    if (rec is None or ctx.traced is None or not ctx.traced.steps_max
            or counter not in rec.counters):
        return None
    return rec.counters[counter] / ctx.traced.steps_max
