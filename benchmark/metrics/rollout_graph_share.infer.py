"""Share of the traced batches' rollouts replayed from a CUDA graph: the
program's ``rollout.graph`` counter over it and ``rollout.eager`` (the
rollouts run op by op), in %.  The counters count only while a profiler
records, so they hold the traced batches alone; a program without them
reads nothing."""


def read(layer):
    from adaptiveisp_tpu_torch.obs import profile

    counts = getattr(profile, "COUNTS", None)
    if counts is None or not layer.get("traced_images"):
        return None
    graph, eager = counts.get("rollout.graph"), counts.get("rollout.eager")
    if graph is None and eager is None:
        return None
    return 100.0 * (graph or 0) / ((graph or 0) + (eager or 0))
