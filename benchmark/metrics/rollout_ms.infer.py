"""Median seconds of a batch's 5-step rollout (``AdaptiveISP.process``),
timed by the benchmark around the call, ending in a synchronize, in ms."""

import statistics


def read(layer):
    spans = (layer.get("spans") or {}).get("rollout")
    return statistics.median(spans) * 1e3 if spans else None
