"""Device ms an iteration under the ``yolo_retouch`` scope, its backward to
the input included: the reward detector's forward and loss."""


def read(layer):
    trace, iters = layer.get("trace"), layer.get("traced_iters")
    comps = (trace or {}).get("components") or {}
    if not iters or not comps.get("yolo_retouch", {}).get("ms"):
        return None
    return comps["yolo_retouch"]["ms"] / iters
