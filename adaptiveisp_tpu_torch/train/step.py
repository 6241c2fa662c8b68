"""The actor-critic train step (port of ``adaptiveisp_tpu/train/step.py``).

One backward pass over ``value_loss + agent_loss`` (the original's two
sequential ``backward()`` calls give the same gradients: ``value_loss``
reaches only the critic, since q is detached in the advantage, and
``agent_loss`` reaches the agent through the surrogate and the render, and
the critic through ``-q``).  The three detach sites are the JAX package's:
the input-image loss in the reward, q in the advantage, and the advantage
in the surrogate term.  The frozen detector runs in eval mode with no
parameter gradients; the reward's gradient reaches the agent through the
retouched image.  In train mode the agent samples its action, and both
networks use flax BatchNorm statistics (``policy/nets.py``); the critic runs
twice, its running statistics chained from the first call to the second.
Per-network clip by global norm and Adam live in :mod:`.optim`.

The phases run under ``torch.profiler.record_function`` scopes named as the
JAX step's ``named_scope``s (``agent_fwd``, ``yolo_input``,
``yolo_retouch``, ``value_net``, ``optimizer``): a trace of the step
(``obs/trace.py``) puts each kernel, the backward's too, in its component.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional

import torch
from torch.profiler import record_function

from adaptiveisp_tpu_torch.detect.loss import LossHyp, per_image_loss_batch
from adaptiveisp_tpu_torch.detect.model import frozen
from adaptiveisp_tpu_torch.ops.math import clip
from adaptiveisp_tpu_torch.policy.states import (
    STATE_STEP_DIM,
    STATE_STOPPED_DIM,
)


@dataclasses.dataclass
class TrainState:
    """The networks (parameters and BatchNorm statistics live in the
    modules), one optimizer each, and the step count."""

    agent: torch.nn.Module
    value: torch.nn.Module
    agent_opt: torch.optim.Optimizer
    value_opt: torch.optim.Optimizer
    step: int = 0


class StepOutput(NamedTuple):
    state: TrainState
    retouch: torch.Tensor
    new_states: torch.Tensor
    metrics: Dict[str, torch.Tensor]


def init_train_state(agent, value, agent_tx: Callable, value_tx: Callable
                     ) -> TrainState:
    """agent_tx / value_tx: ``params -> torch.optim.Optimizer`` (e.g.
    :func:`.optim.make_optimizer`, or plain SGD in a test)."""
    return TrainState(agent, value, agent_tx(list(agent.parameters())),
                      value_tx(list(value.parameters())))


def _detector_loss(yolo, imgs, targets, tmask, anchors_grid, hyp, cfg):
    preds = yolo(imgs)
    loss, comps = per_image_loss_batch(preds, targets, tmask, anchors_grid,
                                       hyp)
    return clip(loss * cfg.detect_loss_weight, 0.0, 1.0), comps


def make_train_step(yolo, cfg, tcfg, anchors_grid, hyp: LossHyp,
                    cached_input_loss: bool = False):
    """The train step closure over the frozen detector.

    cached_input_loss: the batch carries the input images' loss [N, 1]
    (weighted and clipped, e.g. from :func:`make_input_loss_fn` when the
    image was written to the pool) and the step skips the input-image
    detector forward; the detector is frozen, so the value is the same.
    """
    yolo = frozen(yolo)

    def train_step(state: TrainState, batch, generator: torch.Generator,
                   progress, mark: Optional[Callable[[str], None]] = None
                   ) -> StepOutput:
        """batch = (imgs, z, states, targets, tmask[, loss_in]); generator
        draws the agent's dropout masks; ``mark(name)``, when given, is
        called after each phase ("agent", "detector", "critic", "backward",
        "optimizer") for timing."""
        agent, value = state.agent.train(), state.value.train()
        if cached_input_loss:
            imgs, z, states, targets, tmask, loss_in = batch
        else:
            imgs, z, states, targets, tmask = batch

        with record_function("agent_fwd"):
            retouch, new_states, surrogate, penalty, _, info = agent(
                imgs, z, states, progress, train=True, generator=generator)
        stopped = new_states[:, STATE_STOPPED_DIM:STATE_STOPPED_DIM + 1]
        if mark:
            mark("agent")

        if cached_input_loss:
            detect_input_loss = loss_in
        else:
            with torch.no_grad(), record_function("yolo_input"):
                detect_input_loss, _ = _detector_loss(
                    yolo, imgs, targets, tmask, anchors_grid, hyp, cfg)
        with record_function("yolo_retouch"):
            detect_retouch_loss, retouch_comps = _detector_loss(
                yolo, retouch, targets, tmask, anchors_grid, hyp, cfg)
        if mark:
            mark("detector")

        reward = ((cfg.all_reward + (1 - cfg.all_reward) * stopped)
                  * (detect_input_loss.detach() - detect_retouch_loss)
                  * cfg.critic_logit_multiplier)
        if cfg.use_penalty:
            reward = reward - penalty

        with record_function("value_net"):
            old_value = value(imgs, states)
            new_value = value(retouch, new_states)
        clear_final = (new_states[:, STATE_STEP_DIM:STATE_STEP_DIM + 1]
                       > cfg.maximum_trajectory_length).to(torch.float32)
        new_value = new_value * (1.0 - clear_final)

        if tcfg.use_truncated:
            retouch_mean = retouch.mean(dim=(1, 2, 3))[:, None]
            truncated = ((retouch_mean > 0.01)
                         & (retouch_mean < tcfg.max_brightness)
                         ).to(torch.float32)
            q_value = reward + ((1.0 - stopped) * cfg.discount_factor
                                * new_value * (1.0 - truncated))
        else:
            q_value = reward + (1.0 - stopped) * cfg.discount_factor * new_value

        advantage = q_value.detach() - old_value
        value_loss = torch.mean(advantage ** 2)
        if cfg.use_TD:
            routine_loss = -q_value * cfg.parameter_lr_mul
            adv = -advantage
        else:
            routine_loss = -reward
            adv = -reward
        agent_loss = torch.mean(routine_loss + surrogate * adv.detach())
        if mark:
            mark("critic")

        state.agent_opt.zero_grad(set_to_none=True)
        state.value_opt.zero_grad(set_to_none=True)
        (value_loss + agent_loss).backward()
        if mark:
            mark("backward")
        with record_function("optimizer"):
            state.agent_opt.step()
            state.value_opt.step()
        state.step += 1
        if mark:
            mark("optimizer")

        retouch = retouch.detach()
        metrics = {
            "agent_loss": agent_loss.detach(),
            "value_loss": value_loss.detach(),
            "detect_input_loss": detect_input_loss.mean().detach(),
            "detect_retouch_loss": detect_retouch_loss.mean().detach(),
            "loss_components": torch.stack(
                [retouch_comps["box"].mean(), retouch_comps["obj"].mean(),
                 retouch_comps["cls"].mean()]).detach(),
            "reward": reward.mean().detach(),
            "penalty": penalty.mean().detach(),
            "q_value": q_value.mean().detach(),
            "selected_filter": info["selected_filter"],
            "retouch_mean": retouch.mean(),
            "retouch_finite": torch.isfinite(retouch).all(),
            # per image, weighted and clipped: the written-back pool slot's
            # cached input loss
            "retouch_loss_per_image": detect_retouch_loss.detach(),
        }
        return StepOutput(state, retouch, new_states.detach(), metrics)

    return train_step


def make_input_loss_fn(yolo, cfg, anchors_grid, hyp: LossHyp):
    """The detector loss of raw pool images, weighted and clipped exactly as
    the step's input loss: seeds the cached losses of fresh pool slots."""
    yolo = frozen(yolo)

    @torch.no_grad()
    def fn(imgs, targets, tmask):
        return _detector_loss(yolo, imgs, targets, tmask, anchors_grid, hyp,
                              cfg)[0]

    return fn
