"""Median ms of ``ClipAdam`` for both networks an iteration: the ``mark``
interval backward -> optimizer, ending in a synchronize."""

import statistics


def read(layer):
    spans = layer.get("optimizer_ms")
    return statistics.median(spans) if spans else None
