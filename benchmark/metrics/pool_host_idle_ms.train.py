"""Device idle ms a training iteration under the trainer loop's and the
replay pool's spans: the traced window's idle stretches whose innermost host
event is the program's span ``trainer``, ``pool`` or ``feeder`` or a name
under one of them after a ``.`` (the step's own scopes and ``train_step``
are not among them), in ms, over the traced iterations."""

LAYERS = ("trainer", "pool", "feeder")


def _under(label, names):
    return any(label == n or label.startswith(n + ".") for n in names)


def read(layer):
    from adaptiveisp_tpu_torch.obs import profile

    if not hasattr(profile, "span"):    # a program without the spans
        return None
    trace, iters = layer.get("trace"), layer.get("traced_iters")
    if not trace or not iters:
        return None
    idle = sum(s for label, s in trace["gaps"] if _under(label, LAYERS))
    return idle * 1e3 / iters
