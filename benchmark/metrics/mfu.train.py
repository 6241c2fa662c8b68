"""The whole training step's share of the card's peak: the model FLOPs of
one reference step (matrix products and convolutions of the forward and
backward, from their shapes; the reward detector's at the peak of the
dtype it trains in, bf16, the agent's and critic's at the FP32 rate),
times the iterations of the window, over the window, in %."""

from benchmark.roofline.peaks import FLOPS


def read(layer):
    flops, units = layer.get("flops_by_dtype"), layer.get("units")
    window = layer.get("window_s")
    if not flops or not units or not window:
        return None
    at_peak = sum(f / FLOPS[dtype] for dtype, f in flops.items())
    return 100.0 * at_peak * units / window
