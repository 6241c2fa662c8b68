"""K1 (``nlm_fwd_kernel``) in the traced training iterations as a share of
its roofline: the frozen least time of each launch, for the images its
gate turned on, over K1's device time, in %."""

from benchmark.roofline.devicetrace import kernel_seconds
from benchmark.roofline.kernels import nlm_bound


def read(layer):
    trace, launches = layer.get("trace"), layer.get("nlm_fwd_launches")
    if not trace or not launches:
        return None
    count, secs = kernel_seconds(trace, "nlm_fwd_kernel")
    if count != len(launches) or secs <= 0:
        return None
    return 100.0 * sum(nlm_bound(*g)["bound_ms"] for g in launches) \
        * 1e-3 / secs
