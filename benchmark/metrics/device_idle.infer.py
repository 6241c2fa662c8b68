"""Share of the traced window in which no kernel, copy or fill ran on the
device, in %."""


def read(layer):
    trace = layer.get("trace")
    if not trace or trace["window_s"] <= 0 or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
