"""Median seconds of a batch's YOLO forward, NMS and the fetch of its
detections to the host (``Detector.detect``), timed by the benchmark, in
ms."""

import statistics


def read(layer):
    spans = (layer.get("spans") or {}).get("detect")
    return statistics.median(spans) * 1e3 if spans else None
