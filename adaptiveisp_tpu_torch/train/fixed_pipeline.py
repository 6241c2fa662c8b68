"""Optimise a FIXED (non-adaptive) ISP pipeline against the detection loss
(port of ``adaptiveisp_tpu/train/fixed_pipeline.py``).

The paper's baseline for AdaptiveISP (71.4 mAP) is a fixed optimised
pipeline (70.1 mAP, README.md:9): gradient descent on the raw (pre-squash)
parameters of a fixed filter chain, minimising the frozen detector's loss
over a dataset.  The chain is differentiable on both devices: on the card
``denoise`` runs K1 forward and K2 backward, and the fused render (K4)
takes its gradient through the stage-by-stage chain.

    stages, raw, history = optimize_fixed_pipeline(
        cfg, ("exposure", "improved_wb", "ccm", "gamma", "sharpen"),
        yolo, anchors_grid, batches)
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence

import numpy as np
import torch

from adaptiveisp_tpu_torch.detect.loss import LossHyp, per_image_loss_batch
from adaptiveisp_tpu_torch.detect.model import frozen
from adaptiveisp_tpu_torch.ops import bank
from adaptiveisp_tpu_torch.train.optim import adam, cosine_decay_schedule


def init_raw_params(cfg, stage_names: Sequence[str], device=None
                    ) -> Dict[str, torch.Tensor]:
    """Zero raw features per stage, ``{f"{i}_{name}": [1, n]}`` (squash(0)
    is each filter's neutral-ish midpoint).

    CCM is the exception: zero features squash to the all-zero matrix,
    whose row sums vanish in the row normalisation (reference
    filters.py:705-707 divides by them with no epsilon).  CCM starts at the
    raw preimage of the identity matrix instead."""
    out = {}
    for i, name in enumerate(stage_names):
        n = bank.get_spec(cfg, name).n_params
        if name == "ccm":
            lo, hi = cfg.ccm_range
            target = np.eye(3, dtype=np.float64).reshape(1, 9)
            feat = np.arctanh(2.0 * (target - lo) / (hi - lo) - 1.0)
            t = torch.as_tensor(feat, dtype=torch.float32)
        else:
            t = torch.zeros((1, n), dtype=torch.float32)
        out[f"{i}_{name}"] = t.to(device)
    return out


def squash_stages(cfg, stage_names: Sequence[str], raw: Dict):
    """[(name, squashed params)] of the chain."""
    return [(name, bank.get_spec(cfg, name).squash(cfg, raw[f"{i}_{name}"]))
            for i, name in enumerate(stage_names)]


def render_with_raw_params(cfg, img, stage_names: Sequence[str], raw: Dict,
                           allow_fused: bool = True):
    """Squash each stage's raw params and run the pipeline (on the card
    with the fused render unless ``allow_fused=False``)."""
    return bank.render_pipeline(cfg, img, squash_stages(cfg, stage_names,
                                                        raw),
                                allow_fused=allow_fused)


def make_fixed_pipeline_step(cfg, stage_names: Sequence[str], yolo,
                             anchors_grid, hyp: LossHyp,
                             grad_mask: Dict = None,
                             allow_fused: bool = True):
    """One optimisation step over the pipeline's raw params.

    Returns (step, eval_loss): ``step(raw, opt, images, targets, tmask)``
    takes the mean detection loss's gradient with respect to ``raw``,
    multiplies it by ``grad_mask`` (same keys, values 0/1: the curriculum
    freezes stages this way), updates ``raw`` in place with ``opt`` (an
    optimizer over ``raw``'s tensors) and returns the loss before the
    update; ``eval_loss(raw, images, targets, tmask)`` is that loss alone.
    ``yolo`` (a ``DetectionModel``) is frozen here: eval mode, no parameter
    gradients.  The JAX function's ``tx`` and ``yolo_vars`` are the
    optimizer and the module's own weights here."""
    frozen(yolo)

    def loss_fn(raw, images, targets, tmask):
        rendered = render_with_raw_params(cfg, images, stage_names, raw,
                                          allow_fused)
        losses, _ = per_image_loss_batch(yolo(rendered), targets, tmask,
                                         anchors_grid, hyp)
        return losses.mean()

    def step(raw, opt, images, targets, tmask):
        leaves = [v.requires_grad_(True) for v in raw.values()]
        loss = loss_fn(raw, images, targets, tmask)
        grads = torch.autograd.grad(loss, leaves)
        for (key, p), g in zip(raw.items(), grads):
            p.grad = g if grad_mask is None else g * grad_mask[key]
        opt.step()
        for p in leaves:
            p.grad = None
        return loss.detach()

    @torch.no_grad()
    def eval_loss(raw, images, targets, tmask):
        return loss_fn(raw, images, targets, tmask)

    return step, eval_loss


# stages whose parameters act on global luminance: safe first-phase targets
# for the curriculum (from a dark start the color/spatial stages have
# degenerate descent directions, and optimising all five from neutral
# collapses the render to black)
LUMINANCE_STAGES = ("exposure", "gamma", "tone", "contrast")


def optimize_fixed_pipeline(cfg, stage_names: Sequence[str], yolo,
                            anchors_grid, batches: Iterable,
                            hyp: LossHyp = None, lr: float = 3e-2,
                            steps: int = 200, log_every: int = 50,
                            verbose: bool = True, curriculum: bool = True):
    """batches: iterable of (images, targets, tmask) tensors on the
    detector's device.

    curriculum=True fits the luminance stages alone for the first third of
    the steps (the others' gradients masked to 0), then all stages with
    fresh Adam moments and a cosine-decayed rate from lr / 3.  Every
    ``log_every // 5`` steps the current parameters are scored on up to 8
    cached batches, and the best-scoring ones are returned.  Renders
    without the fused pass (every step is differentiated).

    Returns (squashed_stages, raw_params, loss_history).
    """
    hyp = hyp or LossHyp()
    raw = init_raw_params(cfg, stage_names,
                          device=next(yolo.parameters()).device)
    phase1_steps = 0
    step_phase1 = None
    lum = [n in LUMINANCE_STAGES for n in stage_names]
    two_phase = curriculum and any(lum) and not all(lum)
    if two_phase:
        phase1_steps = steps // 3
    # phase 2 runs a gentler, decaying optimizer with fresh moments: the
    # all-stage objective has a collapse basin next to its optimum, which
    # the constant phase-1 rate runs into
    tx1 = adam(lr)
    tx2 = adam(cosine_decay_schedule(lr / 3.0, max(steps - phase1_steps, 1),
                                     alpha=0.1))
    tx_full = tx2 if two_phase else tx1
    opt = tx1(list(raw.values()))
    step_full, eval_loss = make_fixed_pipeline_step(
        cfg, stage_names, yolo, anchors_grid, hyp, allow_fused=False)
    if two_phase:
        mask = {f"{i}_{n}": 1.0 if n in LUMINANCE_STAGES else 0.0
                for i, n in enumerate(stage_names)}
        step_phase1, _ = make_fixed_pipeline_step(
            cfg, stage_names, yolo, anchors_grid, hyp, grad_mask=mask,
            allow_fused=False)

    # best iterate on a SMOOTHED objective: one batch's loss is too noisy
    # to rank iterates, and the final iterate of this nonconvex objective
    # is not trustworthy either
    eval_every = max(1, log_every // 5)
    best_loss = float("inf")
    best_raw = {k: v.detach().clone() for k, v in raw.items()}

    def smoothed(cache):
        return float(np.mean([float(eval_loss(raw, *b)) for b in cache[:8]]))

    history: List[float] = []
    batch_iter = iter(batches)
    cache = []
    for it in range(steps):
        try:
            batch = next(batch_iter)
            cache.append(batch)
        except StopIteration:
            batch_iter = iter(cache)
            batch = next(batch_iter)
        if two_phase and it == phase1_steps:
            opt = tx_full(list(raw.values()))  # fresh moments for phase 2
        step = step_phase1 if it < phase1_steps else step_full
        history.append(float(step(raw, opt, *batch)))
        if it % eval_every == 0 or it == steps - 1:
            ev = smoothed(cache)
            if ev < best_loss:
                best_loss = ev
                best_raw = {k: v.detach().clone() for k, v in raw.items()}
        if verbose and it % log_every == 0:
            phase = "lum" if it < phase1_steps else "all"
            print(f"[fixed-pipeline {it} {phase}] detect loss "
                  f"{history[-1]:.4f} (best smoothed {best_loss:.4f})",
                  flush=True)

    # the returned pipeline is the best smoothed-loss iterate: late
    # divergence or collapse cannot destroy a good baseline
    return squash_stages(cfg, stage_names, best_raw), best_raw, history
