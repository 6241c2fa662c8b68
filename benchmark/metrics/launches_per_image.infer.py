"""Device kernels launched per image in the traced batches (the profiler's
kernel count over the traced images)."""


def read(layer):
    trace, images = layer.get("trace"), layer.get("traced_images")
    if not trace or not images or not trace["kernels"]:
        return None
    return trace["kernels"] / images
