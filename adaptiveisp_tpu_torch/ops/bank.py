"""Filter registry and batched render paths (port of
``adaptiveisp_tpu/ops/bank.py``).

  * ``render_candidates`` — all K candidates stacked [N, K, H, W, 3].
  * ``render_blend``      — one-hot weighted sum of the candidates; the gated
    op (NLM denoise) gets its one-hot column as a per-image gate, so only the
    images that selected it pay for the kernel.
  * ``render_switch``     — renders only the filter the whole batch shares.
  * ``render_fixed`` / ``render_pipeline`` — fixed-parameter renders; on
    the card ``render_pipeline`` runs each maximal run of fusable stages as
    one pass of the K4 kernel (``ops/cuda/pipeline.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence, Tuple

import torch

from adaptiveisp_tpu_torch.ops import filters as F
from adaptiveisp_tpu_torch.ops import masks as M
from adaptiveisp_tpu_torch.ops.math import clip, lerp


@dataclasses.dataclass(frozen=True)
class FilterSpec:
    name: str
    short_name: str
    n_params: int
    squash: Callable  # (cfg, raw_feat[N, n_params]) -> params
    apply: Callable   # (cfg, img_nhwc, params) -> img_nhwc
    # gate-capable: apply accepts gate=[N] blend weights and may skip images
    # whose weight is exactly 0 (their blend contribution is zero)
    gated: bool = False


def _spec(name, short, n, squash, apply, gated=False):
    return FilterSpec(name, short, n, squash, apply, gated)


REGISTRY = {
    "exposure": _spec("exposure", "E", 1, F.squash_exposure, F.apply_exposure),
    "gamma": _spec("gamma", "G", 1, F.squash_gamma, F.apply_gamma),
    "ccm": _spec("ccm", "CCM", 9, F.squash_ccm, F.apply_ccm),
    "sharpen": _spec("sharpen", "Shr", 1, F.squash_sharpen, F.apply_sharpen),
    "sharpen_v2": _spec("sharpen_v2", "Shr", 1, F.squash_sharpen_v2,
                        F.apply_sharpen_v2),
    "sharpen_usm": _spec("sharpen_usm", "USM", 2, F.squash_sharpen_usm,
                         F.apply_sharpen_usm),
    "denoise": _spec("denoise", "NLM", 1, F.squash_denoise, F.apply_denoise,
                     gated=True),
    "tone": _spec("tone", "T", 8, F.squash_tone, F.apply_tone),
    "tone_v2": _spec("tone_v2", "T", 8, F.squash_tone_v2, F.apply_tone_v2),
    "contrast": _spec("contrast", "Ct", 1, F.squash_contrast,
                      F.apply_contrast),
    "saturation_plus": _spec("saturation_plus", "S+", 1,
                             F.squash_saturation_plus, F.apply_saturation_plus),
    "wnb": _spec("wnb", "BW", 1, F.squash_wnb, F.apply_wnb),
    "improved_wb": _spec("improved_wb", "W", 3, F.squash_improved_wb,
                         F.apply_improved_wb),
    "color": _spec("color", "C", 24, F.squash_color, F.apply_color),
}

# the curve filters' parameter counts follow cfg.curve_steps
_CFG_PARAMS = {"tone": lambda cfg: cfg.curve_steps,
               "tone_v2": lambda cfg: cfg.curve_steps,
               "color": lambda cfg: 3 * cfg.curve_steps}


def _resolve(cfg, spec: FilterSpec) -> FilterSpec:
    fn = _CFG_PARAMS.get(spec.name)
    if fn is None:
        return spec
    n = fn(cfg)
    return spec if n == spec.n_params else dataclasses.replace(
        spec, n_params=n)


def filter_specs(cfg) -> Tuple[FilterSpec, ...]:
    return tuple(_resolve(cfg, REGISTRY[name]) for name in cfg.filters)


def get_spec(cfg, name: str) -> FilterSpec:
    return _resolve(cfg, REGISTRY[name])


def param_offsets(cfg) -> Tuple[Tuple[int, int], ...]:
    """(start, end) slices of each filter's params in the concatenated
    per-step parameter vector."""
    out, total = [], 0
    for s in filter_specs(cfg):
        out.append((total, total + s.n_params))
        total += s.n_params
    return tuple(out)


def apply_one(cfg, spec: FilterSpec, img, params, mask_params=None,
              gate=None):
    """One full filter step: masked lerp + clip.

    gate: optional [N] blend weights for gate-capable ops; the value returned
    for a gated-off image is not the filtered image, so callers multiply by
    the same weights (render_blend does)."""
    mask = M.get_mask(cfg, img, mask_params)
    if spec.gated and gate is not None:
        filtered = spec.apply(cfg, img, params, gate=gate)
    else:
        filtered = spec.apply(cfg, img, params)
    return clip(lerp(img, filtered, mask), 0.0, 1.0)


def render_candidates(cfg, img, params_list: Sequence, mask_params_list=None):
    """All K filtered candidates, stacked on dim 1 -> [N, K, H, W, 3]."""
    outs = []
    for k, spec in enumerate(filter_specs(cfg)):
        mp = None if mask_params_list is None else mask_params_list[k]
        outs.append(apply_one(cfg, spec, img, params_list[k], mp))
    return torch.stack(outs, dim=1)


def render_blend(cfg, img, params_list: Sequence, onehot,
                 mask_params_list=None):
    """One-hot blend of all candidates; onehot [N, K] -> [N, H, W, 3]."""
    out = torch.zeros_like(img)
    for k, spec in enumerate(filter_specs(cfg)):
        mp = None if mask_params_list is None else mask_params_list[k]
        gate = onehot[:, k] if spec.gated else None
        cand = apply_one(cfg, spec, img, params_list[k], mp, gate=gate)
        out = out + cand * onehot[:, k, None, None, None]
    return out


def render_switch(cfg, img, params_list: Sequence, selected_id: int,
                  mask_params_list=None):
    """Render only the selected filter, one action for the whole batch
    (``selected_id`` a Python int or a scalar tensor)."""
    k = int(selected_id)
    spec = filter_specs(cfg)[k]
    mp = None if mask_params_list is None else mask_params_list[k]
    return apply_one(cfg, spec, img, params_list[k], mp)


def render_fixed(cfg, img, name: str, params):
    """Fixed-parameter render (no final clip, like the original
    ``Filter.run``)."""
    spec = get_spec(cfg, name)
    mask = M.get_mask(cfg, img, None)
    return lerp(img, spec.apply(cfg, img, params), mask)


def fusable_runs(stages: Sequence[Tuple[str, torch.Tensor]]):
    """The launches of ``render_pipeline`` on the card: ``(True, run)`` for
    each maximal run of fusable stages that one K4 pass takes (a run at the
    kernel's stage or sharpen limit starts a new one), ``(False, [stage])``
    for each other stage."""
    from adaptiveisp_tpu_torch.ops.cuda.pipeline import FUSABLE, fits

    out, run = [], []
    for stage in stages:
        if stage[0] in FUSABLE and fits([s[0] for s in run] + [stage[0]]):
            run.append(stage)
            continue
        if run:
            out.append((True, run))
            run = []
        if stage[0] in FUSABLE:
            run = [stage]
        else:
            out.append((False, [stage]))
    if run:
        out.append((True, run))
    return out


def render_pipeline(cfg, img, stages: Sequence[Tuple[str, torch.Tensor]],
                    allow_fused: bool = True):
    """Sequential scripted pipeline of (filter_name, params) stages.

    For a CUDA tensor (with masking off) each run of :func:`fusable_runs`
    is one launch of the K4 kernel, one device-memory read and write for
    the whole run; ``denoise`` (K1 through
    ``nlm_gray_dispatch``), ``tone_v2`` and ``sharpen_usm`` run on their
    own.  Gradients go through the stage-by-stage chain (``fused_run``).
    On the CPU, or with ``allow_fused=False``, the chain runs stage by
    stage.
    """
    if not (allow_fused and not cfg.masking and img.is_cuda):
        for name, params in stages:
            img = render_fixed(cfg, img, name, params)
        return img

    from adaptiveisp_tpu_torch.ops.cuda.pipeline import fused_run

    for fused, group in fusable_runs(stages):
        img = (fused_run(cfg, img, group) if fused
               else render_fixed(cfg, img, *group[0]))
    return img
