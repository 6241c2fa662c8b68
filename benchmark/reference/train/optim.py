"""Optimizer and learning-rate schedule of the actor-critic (port of
``adaptiveisp_tpu/train/optim.py``).

Adam for each network after clipping that network's gradients to a global
norm of 1e-5, with the step-wise exponential decay
lr(t) = lr0 * 0.1^(3 t / max_iter).  The arithmetic is optax's
``chain(clip_by_global_norm, adam)``, not torch's: the clip is
``g * max_norm / norm`` when norm >= max_norm (``clip_grad_norm_`` divides by
norm + 1e-6, a relative change of 1e-1 to 1e-3 at max_norm 1e-5), eps sits
outside the square root, and update t (from 0) uses lr ``schedule(t)``.
:func:`adam` and :func:`cosine_decay_schedule` are optax's ``adam`` and
``cosine_decay_schedule`` in the same arithmetic (the fixed-pipeline
optimiser's).
"""

from __future__ import annotations

import functools
import math

import torch


def exp_segment_schedule(base_lr: float, max_iter: int, lr_decay: float = 0.1,
                         segments: int = 3):
    def schedule(step):
        return base_lr * lr_decay ** (1.0 * step * segments / max_iter)

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0):
    """optax's: init * ((1 - alpha) * (1 + cos(pi * t / T)) / 2 + alpha),
    t capped at T = decay_steps."""
    def schedule(step):
        t = min(step, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / decay_steps))
        return init_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


class ClipAdam(torch.optim.Optimizer):
    """Clip by global norm over all of this optimizer's parameters, then
    Adam, as optax; ``clip_norm=None`` is Adam alone.  A parameter without
    a gradient counts as a zero gradient (optax sees every leaf)."""

    def __init__(self, params, schedule, clip_norm: float = 1e-5,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        super().__init__(params, {"b1": b1, "b2": b2, "eps": eps})
        self.schedule = schedule
        self.clip_norm = clip_norm
        self.count = 0

    @torch.no_grad()
    def step(self, closure=None):
        entries = [(group, p, torch.zeros_like(p) if p.grad is None
                    else p.grad)
                   for group in self.param_groups for p in group["params"]]
        if self.clip_norm is not None:
            norm = torch.sqrt(sum(torch.sum(g * g) for _, _, g in entries))
            clip = norm >= self.clip_norm
        lr = self.schedule(self.count)
        self.count += 1
        for group, p, g in entries:
            b1, b2, eps = group["b1"], group["b2"], group["eps"]
            if self.clip_norm is not None:
                g = torch.where(clip, g / norm * self.clip_norm, g)
            st = self.state[p]
            if not st:
                st["mu"] = torch.zeros_like(p)
                st["nu"] = torch.zeros_like(p)
            st["mu"].mul_(b1).add_(g * (1.0 - b1))
            st["nu"].mul_(b2).add_(g * g * (1.0 - b2))
            mu_hat = st["mu"] / (1.0 - b1 ** self.count)
            nu_hat = st["nu"] / (1.0 - b2 ** self.count)
            p.add_(mu_hat / (torch.sqrt(nu_hat) + eps) * -lr)

    def state_dict(self):
        """torch's optimizer state plus ``count``, the update counter the
        learning-rate schedule reads, so a restored optimizer continues the
        schedule where it stopped."""
        sd = super().state_dict()
        sd["count"] = self.count
        return sd

    def load_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        self.count = int(state_dict.pop("count"))
        super().load_state_dict(state_dict)


def make_optimizer(base_lr: float, max_iter: int, clip_norm: float = 1e-5,
                   lr_decay: float = 0.1, segments: int = 3,
                   b1: float = 0.9, b2: float = 0.999):
    """Factory ``params -> ClipAdam`` (the optax transform's role: the
    train state builds one optimizer per network from it)."""
    return functools.partial(
        ClipAdam, schedule=exp_segment_schedule(base_lr, max_iter, lr_decay,
                                                segments),
        clip_norm=clip_norm, b1=b1, b2=b2, eps=1e-8)


def adam(learning_rate, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8):
    """optax.adam: factory ``params -> ClipAdam`` without the clip;
    ``learning_rate`` a float or a schedule ``update count -> lr``."""
    schedule = (learning_rate if callable(learning_rate)
                else lambda step: learning_rate)
    return functools.partial(ClipAdam, schedule=schedule, clip_norm=None,
                             b1=b1, b2=b2, eps=eps)
