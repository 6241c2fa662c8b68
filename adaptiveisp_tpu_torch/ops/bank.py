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
  * ``make_sharded_render`` — the scripted render over a (data x spatial)
    mesh: each rank renders its block of rows.

Every render takes ``rows`` (a ``parallel.Rows``) when ``img`` is a
spatial rank's block of rows: a windowed filter then runs on the block
with its neighbours' halo rows (``HALO``) and crops them, and a mask is
drawn on the frame's grid, so the block equals those rows of the whole
frame's render.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence, Tuple

import torch

from adaptiveisp_tpu_torch import parallel
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


def short_names(cfg) -> Tuple[str, ...]:
    return tuple(s.short_name for s in filter_specs(cfg))


def param_counts(cfg) -> Tuple[int, ...]:
    return tuple(s.n_params for s in filter_specs(cfg))


def param_offsets(cfg) -> Tuple[Tuple[int, int], ...]:
    """(start, end) slices of each filter's params in the concatenated
    per-step parameter vector."""
    out, total = [], 0
    for n in param_counts(cfg):
        out.append((total, total + n))
        total += n
    return tuple(out)


# the rows above and below a row that a windowed filter reads, and whether
# the frame's edges wrap around (NLM's 11 x 11 search and 5 x 5 patch on
# circular shifts: 5 + 2) or are the frame's own (the sharpens keep the
# frame's first and last rows; the unsharp mask reflects at them)
HALO = {"denoise": (7, True), "sharpen": (1, False),
        "sharpen_v2": (1, False), "sharpen_usm": (2, False)}


def _row_window(rows):
    return None if rows is None else (rows.bounds[0], rows.height)


def _filtered(cfg, spec: FilterSpec, img, params, gate=None, rows=None):
    """``spec.apply`` on img; on a spatial rank's block with the halo of a
    windowed filter, cropped back to the block."""
    def apply(x):
        if spec.gated and gate is not None:
            return spec.apply(cfg, x, params, gate=gate)
        return spec.apply(cfg, x, params)

    if rows is None or spec.name not in HALO:
        return apply(img)
    halo, wrap = HALO[spec.name]
    slab, top, bottom = parallel.with_halo(rows, img, halo, wrap)
    return apply(slab)[:, top:slab.shape[1] - bottom]


def apply_one(cfg, spec: FilterSpec, img, params, mask_params=None,
              gate=None, rows=None):
    """One full filter step: masked lerp + clip.

    gate: optional [N] blend weights for gate-capable ops; the value returned
    for a gated-off image is not the filtered image, so callers multiply by
    the same weights (render_blend does)."""
    mask = M.get_mask(cfg, img, mask_params, _row_window(rows))
    filtered = _filtered(cfg, spec, img, params, gate, rows)
    return clip(lerp(img, filtered, mask), 0.0, 1.0)


def render_candidates(cfg, img, params_list: Sequence, mask_params_list=None):
    """All K filtered candidates, stacked on dim 1 -> [N, K, H, W, 3]."""
    outs = []
    for k, spec in enumerate(filter_specs(cfg)):
        mp = None if mask_params_list is None else mask_params_list[k]
        outs.append(apply_one(cfg, spec, img, params_list[k], mp))
    return torch.stack(outs, dim=1)


def render_blend(cfg, img, params_list: Sequence, onehot,
                 mask_params_list=None, rows=None):
    """One-hot blend of all candidates; onehot [N, K] -> [N, H, W, 3]."""
    out = torch.zeros_like(img)
    for k, spec in enumerate(filter_specs(cfg)):
        mp = None if mask_params_list is None else mask_params_list[k]
        gate = onehot[:, k] if spec.gated else None
        cand = apply_one(cfg, spec, img, params_list[k], mp, gate=gate,
                         rows=rows)
        out = out + cand * onehot[:, k, None, None, None]
    return out


def render_switch(cfg, img, params_list: Sequence, selected_id: int,
                  mask_params_list=None, rows=None):
    """Render only the selected filter, one action for the whole batch
    (``selected_id`` a Python int or a scalar tensor)."""
    k = int(selected_id)
    spec = filter_specs(cfg)[k]
    mp = None if mask_params_list is None else mask_params_list[k]
    return apply_one(cfg, spec, img, params_list[k], mp, rows=rows)


def render_fixed(cfg, img, name: str, params, rows=None):
    """Fixed-parameter render (no final clip, like the original
    ``Filter.run``)."""
    spec = get_spec(cfg, name)
    mask = M.get_mask(cfg, img, None, _row_window(rows))
    return lerp(img, _filtered(cfg, spec, img, params, rows=rows), mask)


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
                    allow_fused: bool = True, rows=None):
    """Sequential scripted pipeline of (filter_name, params) stages.

    For a CUDA tensor (with masking off) each run of :func:`fusable_runs`
    is one launch of the K4 kernel, one device-memory read and write for
    the whole run; ``denoise`` (K1 through
    ``nlm_gray_dispatch``), ``tone_v2`` and ``sharpen_usm`` run on their
    own.  Gradients go through the stage-by-stage chain (``fused_run``).
    On the CPU, or with ``allow_fused=False``, the chain runs stage by
    stage.  ``rows`` (a spatial rank's block) runs the chain stage by
    stage.
    """
    if not (allow_fused and not cfg.masking and img.is_cuda
            and rows is None):
        for name, params in stages:
            img = render_fixed(cfg, img, name, params, rows=rows)
        return img

    from adaptiveisp_tpu_torch.ops.cuda.pipeline import fused_run

    for fused, group in fusable_runs(stages):
        img = (fused_run(cfg, img, group) if fused
               else render_fixed(cfg, img, *group[0]))
    return img


def make_sharded_render(cfg, mesh, names: Sequence[str]):
    """The scripted render over a (data x spatial) mesh
    (``parallel.make_grid``; JAX's ``make_sharded_render``).

    Returns ``fn(block, params_list, height) -> block``: ``block`` is the
    rank's block of the batch (``parallel.shard_image``: its data rows of
    the images, its spatial rows of each), ``params_list`` each stage's
    [n, P] parameters for the rank's images, ``height`` the frames' rows.
    The chain runs stage by stage (``allow_fused=False``, as JAX's); each
    windowed stage exchanges its halo with the neighbouring ranks first
    (``HALO``), so the block equals those rows of
    ``render_pipeline(..., allow_fused=False)`` on the whole frames
    (``parallel.gather_rows`` returns them).  A split whose shortest block
    is shorter than a stage's halo raises."""
    names = tuple(names)
    for name in names:
        get_spec(cfg, name)   # KeyError on an unknown stage

    def fn(block, params_list, height: int):
        rows = parallel.Rows(mesh, int(height))
        parallel.check_rows(rows, max((HALO.get(n, (0,))[0]
                                       for n in names), default=0))
        lo, hi = rows.bounds
        if block.shape[1] != hi - lo:
            raise ValueError(f"the block has {block.shape[1]} rows; this "
                             f"rank's share of {height} is {hi - lo}")
        return render_pipeline(cfg, block, list(zip(names, params_list)),
                               allow_fused=False, rows=rows)

    return fn
