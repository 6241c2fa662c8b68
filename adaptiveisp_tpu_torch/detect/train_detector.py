"""Standalone YOLO detector training: config, optimiser, EMA and the train
step (port of ``adaptiveisp_tpu/detect/train_detector.py``).

The optimiser is optax's arithmetic written out, as ``train/optim.py`` writes
out ``ClipAdam``: per parameter group an optional coupled weight decay
(``g + wd * p``, optax ``add_decayed_weights`` before the transform), then
SGD with a Nesterov trace (``t = g + mu * t``, update ``g + mu * t``), Adam
(decay coupled as above), or AdamW (decay ``wd * p`` added after the
moments, scaled by lr), and ``p += -lr * update``.  Learning rate and
momentum are schedules of the update count, read before the update as
``optax.inject_hyperparams`` reads them, in float32 arithmetic.

The EMA follows ModelEMA: decay ``d = decay * (1 - exp(-updates / tau))``
over the parameters only; BatchNorm statistics stay the model's own.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence

import torch

from adaptiveisp_tpu_torch.detect.loss import LossHyp, batch_loss


@dataclasses.dataclass(frozen=True)
class DetTrainConfig:
    epochs: int = 100
    batch_size: int = 16
    lr0: float = 0.01
    lrf: float = 0.01           # final OneCycle fraction (hyp lrf)
    momentum: float = 0.937
    weight_decay: float = 0.0005
    warmup_epochs: float = 3.0
    warmup_momentum: float = 0.8
    warmup_bias_lr: float = 0.1
    ema_decay: float = 0.9999
    patience: int = 100          # EarlyStopping
    optimizer: str = "SGD"       # SGD | Adam | AdamW
    cos_lr: bool = True          # cosine one-cycle; False = linear lf
    freeze: tuple = ()           # spec layer ids with frozen parameters


def one_cycle(y1: float = 1.0, y2: float = 0.01, steps: int = 100):
    """Cosine y1 -> y2 over `steps` (reference general.py one_cycle)."""
    return lambda x: ((1 - math.cos(x * math.pi / steps)) / 2) * (y2 - y1) + y1


def f32(x) -> torch.Tensor:
    """A float32 scalar on the CPU: schedules compute in float32 as XLA
    does, with Python constants taking the tensor's type."""
    return torch.tensor(x, dtype=torch.float32)


def group_of(name: str, param: torch.Tensor) -> str:
    """smart_optimizer's split: every bias (BatchNorm's included) is "bias",
    a BatchNorm weight "norm", a conv kernel "kernel"."""
    if name.endswith("bias"):
        return "bias"
    return "kernel" if param.ndim > 1 else "norm"


def layer_id(name: str) -> Optional[int]:
    """Spec layer id of a ``model.{i}.*`` parameter name."""
    parts = name.split(".")
    if len(parts) > 1 and parts[0] == "model" and parts[1].isdigit():
        return int(parts[1])
    return None


class DetectorOptimizer(torch.optim.Optimizer):
    """optax's SGD / Adam / AdamW over named parameter groups.

    groups: dicts with ``params``, ``name`` (the key of ``schedules``),
    ``weight_decay`` and ``frozen`` (updates zeroed after the transform, as
    optax ``masked(set_to_zero())``: the state still moves).  schedules:
    ``name -> (lr(count), momentum(count))``, each returning a float32
    tensor; momentum is SGD's trace decay (Adam's b1 is ``b1``)."""

    def __init__(self, groups: List[dict], schedules: Dict[str, tuple],
                 kind: str = "SGD", b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        if kind not in ("SGD", "Adam", "AdamW"):
            raise ValueError(f"unknown optimizer {kind!r}")
        super().__init__(groups, {"weight_decay": 0.0, "frozen": False})
        self.schedules = schedules
        self.kind, self.b1, self.b2, self.eps = kind, b1, b2, eps
        self.count = 0

    def _state(self, p: torch.Tensor, key: str) -> torch.Tensor:
        st = self.state[p]
        if key not in st:
            st[key] = torch.zeros_like(p)
        return st[key]

    @torch.no_grad()
    def step(self, closure=None):
        t = self.count
        self.count += 1
        if self.kind != "SGD":
            # b1 and b2 are float32 hyperparameters: 1 - b in float32
            b1, b2 = f32(self.b1), f32(self.b2)
            c = f32(t + 1)
            omb1, omb2 = float(1.0 - b1), float(1.0 - b2)
            bc1 = float(1.0 - torch.pow(b1, c))
            bc2 = float(1.0 - torch.pow(b2, c))
        for group in self.param_groups:
            params = group["params"]
            if not params:
                continue
            lr_fn, mom_fn = self.schedules[group["name"]]
            lr = float(lr_fn(t))
            wd = group["weight_decay"]
            grads = [torch.zeros_like(p) if p.grad is None else p.grad
                     for p in params]
            if wd and self.kind != "AdamW":      # coupled: g + wd * p
                grads = torch._foreach_add(grads,
                                           torch._foreach_mul(params, wd))
            if self.kind == "SGD":
                mom = float(mom_fn(t))
                traces = [self._state(p, "trace") for p in params]
                torch._foreach_mul_(traces, mom)
                torch._foreach_add_(traces, grads)        # t = g + mu t
                upd = torch._foreach_mul(traces, mom)
                torch._foreach_add_(upd, grads)           # g + mu t
            else:
                mus = [self._state(p, "mu") for p in params]
                nus = [self._state(p, "nu") for p in params]
                torch._foreach_mul_(mus, self.b1)
                torch._foreach_add_(mus, torch._foreach_mul(grads, omb1))
                torch._foreach_mul_(nus, self.b2)
                torch._foreach_add_(nus, torch._foreach_mul(
                    torch._foreach_mul(grads, grads), omb2))
                den = torch._foreach_sqrt(torch._foreach_div(nus, bc2))
                torch._foreach_add_(den, self.eps)
                upd = torch._foreach_div(torch._foreach_div(mus, bc1), den)
                if wd and self.kind == "AdamW":   # decoupled, then lr
                    torch._foreach_add_(upd, torch._foreach_mul(params, wd))
            if group["frozen"]:
                continue
            torch._foreach_mul_(upd, -lr)
            torch._foreach_add_(params, upd)

    def state_dict(self):
        """torch's optimizer state plus ``count``, the update counter the
        schedules read."""
        sd = super().state_dict()
        sd["count"] = self.count
        return sd

    def load_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        self.count = int(state_dict.pop("count"))
        super().load_state_dict(state_dict)


def param_groups(model: torch.nn.Module, decays: Dict[str, float],
                 freeze: Sequence[int] = ()) -> List[dict]:
    """One group per (group_of, frozen) pair present in ``model``."""
    frozen = {int(i) for i in freeze}
    groups: Dict[tuple, dict] = {}
    for name, p in model.named_parameters():
        g = group_of(name, p)
        fz = layer_id(name) in frozen
        groups.setdefault((g, fz), {"params": [], "name": g,
                                    "weight_decay": decays.get(g, 0.0),
                                    "frozen": fz})["params"].append(p)
    return list(groups.values())


def make_detector_optimizer(cfg: DetTrainConfig, steps_per_epoch: int):
    """SGD (Nesterov, cfg.momentum) with decay on the kernels only and a
    cosine one-cycle lr with linear warmup.  Returns (factory
    ``model -> optimizer``, lr schedule)."""
    warm = max(cfg.warmup_epochs * steps_per_epoch, 1.0)

    def lr_schedule(step):
        step = f32(step)
        epoch = step / steps_per_epoch
        lf = ((1 - torch.cos(epoch * math.pi / cfg.epochs)) / 2
              * (cfg.lrf - 1.0) + 1.0)
        warm_frac = torch.clamp(step / warm, 0.0, 1.0)
        return cfg.lr0 * lf * torch.where(step < warm, warm_frac, f32(1.0))

    def momentum(step):
        return f32(cfg.momentum)

    def factory(model):
        sched = (lr_schedule, momentum)
        groups = param_groups(model, {"kernel": cfg.weight_decay})
        return DetectorOptimizer(groups, {"kernel": sched, "norm": sched,
                                          "bias": sched}, "SGD")

    return factory, lr_schedule


class ModelEMA:
    """Exponential moving average of a model's parameters (not its
    buffers), with ModelEMA's ramped decay."""

    def __init__(self, model: torch.nn.Module, decay: float = 0.9999,
                 tau: float = 2000.0):
        self.decay, self.tau = decay, tau
        self.params = {n: p.detach().clone()
                       for n, p in model.named_parameters()}
        self.updates = 0

    @torch.no_grad()
    def update(self, model: torch.nn.Module):
        self.updates += 1
        d = self.decay * (1 - torch.exp(-f32(self.updates) / self.tau))
        live = dict(model.named_parameters())
        ema = list(self.params.values())
        torch._foreach_mul_(ema, float(d))
        torch._foreach_add_(ema, torch._foreach_mul(
            [live[n] for n in self.params], float(1.0 - d)))

    def state_dict(self, model: torch.nn.Module) -> Dict[str, torch.Tensor]:
        """``model.state_dict()`` with the EMA in place of the parameters
        (the model's live BatchNorm statistics kept)."""
        sd = model.state_dict()
        sd.update(self.params)
        return sd


class EarlyStopping:
    """Stop when fitness hasn't improved for `patience` epochs."""

    def __init__(self, patience: int = 30):
        self.best_fitness = 0.0
        self.best_epoch = 0
        self.patience = patience or float("inf")

    def __call__(self, epoch: int, fitness: float) -> bool:
        if fitness >= self.best_fitness:
            self.best_epoch = epoch
            self.best_fitness = fitness
        return (epoch - self.best_epoch) >= self.patience


@dataclasses.dataclass
class DetTrainState:
    """The training state: the model (parameters and BatchNorm statistics
    live in it), its optimizer, the EMA and the step count."""

    model: torch.nn.Module
    optimizer: DetectorOptimizer
    ema: ModelEMA
    step: int = 0


def make_detector_train_step(anchors_grid: Sequence, hyp: LossHyp
                             ) -> Callable:
    """``step(state, images, targets, tmask) -> (state, {"loss",
    "components"})``: train-mode forward (BatchNorm on batch statistics,
    running statistics updated), ``batch_loss``, backward, the optimizer's
    update, the EMA.  The state moves in place; the loss stays on the
    device."""

    def step(state: DetTrainState, images, targets, tmask):
        model = state.model
        model.train()
        total, comps = batch_loss(model(images), targets, tmask,
                                  anchors_grid, hyp)
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        state.optimizer.step()
        state.ema.update(model)
        state.step += 1
        return state, {"loss": total.detach(), "components": comps}

    return step


def init_detector_train_state(model: torch.nn.Module, tx: Callable,
                              ema_decay: float = 0.9999) -> DetTrainState:
    return DetTrainState(model, tx(model), ModelEMA(model, ema_decay), 0)


def fuse_conv_bn(conv_weight, bn_scale, bn_bias, bn_mean, bn_var,
                 eps: float = 1e-5):
    """Fold BatchNorm into the preceding conv for inference (reference
    torch_utils.py:248-268).  conv_weight: OIHW; returns (weight, bias)."""
    std = torch.sqrt(bn_var + eps)
    w = conv_weight * (bn_scale / std)[:, None, None, None]
    b = bn_bias - bn_scale * bn_mean / std
    return w, b
