"""The plain reference's actor-critic steps, with its own replay pool.

What the program drew at random is taken as given, step by step: the slots
its pool sampled and the file each holds, the noise, the dropout
generator's state and the sampled actions.  The reference keeps its own
view of the pool, worked out from the benchmark's files and weights: each
row's image and labels (its own decode of the PNG that the benchmark
wrote, or, for a slot that an earlier step wrote back, its own retouched
image), state and cached input loss.  The pool's batches and write-backs
are judged against that view.

Each step itself runs on the images that the program's pool handed it
(judged against the view first), with the view's states, labels and
cached losses: the reward detector runs in bfloat16, and a difference of
1e-7 in its input images moves single leaves' gradients by some per cent,
as much as the control does (PERF.md), so the agent, render, detector,
critic and ``ClipAdam`` are compared on the same images.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmark.reference import data, models
from benchmark.reference.config import TrainConfig
from benchmark.reference.detect.loss import LossHyp, pad_targets
from benchmark.reference.detect.model import anchors_in_grid_units
from benchmark.reference.policy.states import (
    STATE_STOPPED_DIM,
    get_initial_states,
)
from benchmark.reference.policy.value import Value
from benchmark.reference.train.optim import make_optimizer
from benchmark.reference.train.step import (
    init_train_state,
    make_input_loss_fn,
    make_train_step,
)


def value(cfg_file: Dict, state_dict=None, device="meta") -> Value:
    """As :func:`models.agent`, for the critic."""
    with torch.device("meta"):
        net = Value(models.config(cfg_file))
    if state_dict is None:
        return net
    net = net.to_empty(device=device)
    net.load_state_dict(state_dict)
    return net


def imgsz_hyp(imgsz: int, nc: int, nl: int) -> LossHyp:
    """The trainer's hyp scaling: box *= 3/nl, cls *= nc/80 * 3/nl,
    obj *= (imgsz/640)^2 * 3/nl."""
    return LossHyp(box=0.05 * 3 / nl, cls=0.5 * nc / 80 * 3 / nl,
                   obj=1.0 * (imgsz / 640) ** 2 * 3 / nl)


def leaves(state) -> Dict[str, torch.Tensor]:
    """Every trained parameter by name, agent then critic."""
    out = {f"agent.{k}": p for k, p in state.agent.named_parameters()}
    out.update({f"value.{k}": p for k, p in state.value.named_parameters()})
    return out


def gradients(state) -> Dict[str, torch.Tensor]:
    """Each parameter's ``.grad`` (zero where autograd left none)."""
    return {k: (torch.zeros_like(p) if p.grad is None
                else p.grad.detach().clone())
            for k, p in leaves(state).items()}


def kept(new_states: torch.Tensor) -> torch.Tensor:
    """Rows whose slot keeps the retouched image: every trajectory that
    has not stopped (none is over length within the checked steps)."""
    return new_states[:, STATE_STOPPED_DIM] != 1


def follow(cfg_file: Dict, tcfg_kw: Dict, weights: Dict, drawn: List[Dict],
           device, cfg_overrides: Dict = None) -> Dict:
    """The reference's steps.  ``weights``: the benchmark's agent, value
    and detector state dicts; ``drawn``: per step what the program drew
    (``slots``, ``paths``, ``z``, ``gen_state``, ``progress``,
    ``actions``, the batch's label capacity ``t_max``) and the ``images``
    that its pool handed the step, on which the step runs.

    Returns per step the batch handed to the step (``handed``: images,
    states, cached input losses, targets, target mask, and which rows are
    fresh decodes rather than earlier write-backs), what it leaves in
    the sampled slots (``written``: images, states, cached losses, and
    whether the slot is kept: a refreshed slot reads the initial state and
    is judged by it alone), its losses, sampled actions and (probabilities,
    noise); and the first step's gradients and the parameters after the
    last step."""
    cfg = models.config(cfg_file).replace(**(cfg_overrides or {}))
    cfg_file = dict(cfg_file, agent_config=dict(cfg_file["agent_config"],
                                                **(cfg_overrides or {})))
    if len(drawn) >= cfg.maximum_trajectory_length:
        raise ValueError("the checked steps reach the trajectory length cap")
    tcfg = TrainConfig(**tcfg_kw)
    spec = models.spec(cfg_file)
    yolo = models.detector(cfg_file, weights["detector"], device,
                           dtype=cfg_file["precision"]["train"]["detector"])
    agent = models.agent(cfg_file, weights["agent"], device)
    critic = value(cfg_file, weights["value"], device)
    anchors = anchors_in_grid_units(spec)
    hyp = imgsz_hyp(tcfg.imgsz, spec["nc"], len(spec["anchors"]))
    opt = dict(clip_norm=tcfg.grad_clip_norm, lr_decay=tcfg.lr_decay,
               segments=tcfg.lr_segments)
    state = init_train_state(
        agent, critic,
        make_optimizer(tcfg.lr, tcfg.max_iter_step, **opt),
        make_optimizer(tcfg.lr * cfg.value_lr_mul, tcfg.max_iter_step, **opt))
    step = make_train_step(yolo, cfg, tcfg, anchors, hyp,
                           cached_input_loss=True)
    input_loss = make_input_loss_fn(yolo, cfg, anchors, hyp)
    gen = torch.Generator(device=device)
    own: Dict[int, tuple] = {}  # slot -> (image, state, loss) written back
    out = {"losses": [], "handed": [], "written": [], "selected": [],
           "pdfs": [], "grads": None}
    for d in drawn:
        fresh = [data.load(p, tcfg.imgsz) for p in d["paths"]]
        imgs = torch.as_tensor(np.stack([f[0] for f in fresh]),
                               device=device)
        states = torch.as_tensor(get_initial_states(
            len(fresh), cfg.num_state_dim), device=device)
        targets, tmask = (torch.as_tensor(a, device=device) for a in
                          pad_targets([f[1] for f in fresh], d["t_max"]))
        loss_in = input_loss(imgs, targets, tmask)
        fresh_rows = torch.ones(len(fresh), dtype=torch.bool, device=device)
        for r, slot in enumerate(d["slots"]):
            if int(slot) in own:
                imgs[r], states[r], loss_in[r] = own[int(slot)]
                fresh_rows[r] = False
        gen.set_state(d["gen_state"])
        z = torch.as_tensor(d["z"], device=device)
        res = step(state, (d["images"].to(device), z, states, targets,
                           tmask, loss_in), gen, d["progress"],
                   actions=d["actions"])
        if out["grads"] is None:
            out["grads"] = gradients(state)
        new_loss = res.metrics["retouch_loss_per_image"]
        keep = kept(res.new_states)
        for r, slot in enumerate(d["slots"]):
            if keep[r]:
                own[int(slot)] = (res.retouch[r], res.new_states[r],
                                  new_loss[r])
            else:
                own.pop(int(slot), None)
        out["handed"].append((imgs, states, loss_in, targets, tmask,
                              fresh_rows))
        out["written"].append((res.retouch, torch.where(
            keep[:, None], res.new_states, torch.zeros_like(
                res.new_states)), new_loss, keep))
        out["pdfs"].append((res.metrics["pdf"], z[:, :1]))
        out["losses"].append({k: float(res.metrics[k])
                              for k in ("agent_loss", "value_loss")})
        out["selected"].append(res.metrics["random_filter_id"])
    out["params"] = {k: p.detach().clone()
                     for k, p in leaves(state).items()}
    return out
