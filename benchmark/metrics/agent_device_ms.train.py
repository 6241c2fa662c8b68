"""Device ms an iteration under the train step's ``agent_fwd`` scope, its
backward included (the frozen trace attribution): the agent and the blend
render, K1 and K2 among them."""


def read(layer):
    trace, iters = layer.get("trace"), layer.get("traced_iters")
    comps = (trace or {}).get("components") or {}
    if not iters or not comps.get("agent_fwd", {}).get("ms"):
        return None
    return comps["agent_fwd"]["ms"] / iters
