"""The whole served batch's share of the card's peak: the model FLOPs of one
batch (the plain reference's matrix products and convolutions, counted
from their shapes), each at the peak of the dtype the cell serves it in
(float32 with TF32 off: the FP32 rate), times the batches of the window,
over the window, in %."""

from benchmark.roofline.peaks import FLOPS


def read(layer):
    flops, units = layer.get("flops_by_dtype"), layer.get("units")
    window = layer.get("window_s")
    if not flops or not units or not window:
        return None
    at_peak = sum(f / FLOPS[dtype] for dtype, f in flops.items())
    return 100.0 * at_peak * units / window
