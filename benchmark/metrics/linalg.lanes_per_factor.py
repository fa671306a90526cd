"""Lanes a factor build: the program's ``linalg.factor_lanes`` over its
``linalg.factor_builds`` in the traced solve (the factor calls that
rebuilt at least one lane; the gate rebuilds only the lanes whose c
drifted)."""
from benchmark import spans


def read(ctx):
    rec = spans.record(ctx)
    if rec is None:
        return None
    builds = rec.counters.get("linalg.factor_builds")
    if not builds:
        return None
    return rec.counters["linalg.factor_lanes"] / builds
