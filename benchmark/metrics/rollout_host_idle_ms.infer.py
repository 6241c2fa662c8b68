"""Device idle ms a served batch under the rollout's spans: the traced
window's idle stretches whose innermost host event is the program's span of
the rollout, the agent or the blend render (``rollout``, ``agent``,
``render``, or a name under one of them after a ``.``), in ms, over the
traced batches."""

LAYERS = ("rollout", "agent", "render")


def _under(label, names):
    return any(label == n or label.startswith(n + ".") for n in names)


def read(layer):
    from adaptiveisp_tpu_torch.obs import profile

    if not hasattr(profile, "span"):    # a program without the spans
        return None
    trace, batch = layer.get("trace"), layer.get("batch")
    images = layer.get("traced_images")
    if not trace or not batch or not images:
        return None
    idle = sum(s for label, s in trace["gaps"] if _under(label, LAYERS))
    return idle * 1e3 / (images / batch)
