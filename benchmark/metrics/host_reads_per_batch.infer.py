"""Calls a served batch at which the host waits for the card's stream: the
program's ``host_read.*`` counters (reads back, such as the rollout's stop
mask and NMS's flags, and blocking uploads, ``host_read.upload.*``) over
the traced batches.  The counters count only while a profiler records, so
they hold the traced batches alone; a program without them reads
nothing."""


def read(layer):
    from adaptiveisp_tpu_torch.obs import profile

    counts = getattr(profile, "COUNTS", None)
    batch, images = layer.get("batch"), layer.get("traced_images")
    if counts is None or not batch or not images:
        return None
    reads = sum(n for k, n in counts.items() if k.startswith("host_read."))
    return reads * batch / images
