"""Calls a training iteration at which the host waits for the card's
stream: the program's ``host_read.*`` counters (reads back, such as the
trainer's fetch, and blocking uploads, ``host_read.upload.*``) over the
traced iterations.  The counters count only while a profiler records, so
they hold the traced iterations alone; a program without them reads
nothing."""


def read(layer):
    from adaptiveisp_tpu_torch.obs import profile

    counts = getattr(profile, "COUNTS", None)
    iters = layer.get("traced_iters")
    if counts is None or not iters:
        return None
    reads = sum(n for k, n in counts.items() if k.startswith("host_read."))
    return reads / iters
