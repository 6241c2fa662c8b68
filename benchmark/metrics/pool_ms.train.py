"""Median ms an iteration spends in the trainer loop and the replay pool:
the ``mark`` intervals start -> sample (the pool's sample, the batch's
upload) plus optimizer -> writeback (the host fetch, the divergence guard,
the pool's write-back and refreshes), each ending in a synchronize."""

import statistics


def read(layer):
    spans = layer.get("pool_ms")
    return statistics.median(spans) if spans else None
