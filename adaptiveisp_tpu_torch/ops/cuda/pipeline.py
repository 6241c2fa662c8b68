"""Fused scripted render on the GPU: the wrapper of ``csrc/pipeline_fwd.cu``
(K4) and the autograd function around it.

K4 replaces the TPU kernel
``adaptiveisp_tpu/ops/pallas/pipeline.py::_pipeline_kernel``: one pass of a
chain of fusable stages (the pointwise filters of :data:`POINTWISE` and up to
:data:`HALO_ALLOC` 3x3 sharpens) over an NHWC image, one device-memory read
and one write whatever the chain's length.  Its plain version is the
stage-by-stage chain of ``ops.bank.render_fixed``
(``bank.render_pipeline(..., allow_fused=False)``).  ``ops.bank.
render_pipeline`` sends maximal runs of fusable stages here for CUDA tensors;
the wrappers launch their kernel and raise on anything else, a CPU tensor
included.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from adaptiveisp_tpu_torch.ops.cuda import build

NAME = "pipeline_fwd"
HALO_ALLOC = 4     # sharpen stages one pass takes (its halo, in pixels)
MAX_STAGES = 16    # stages one pass takes (the kernel's stage table)
MAX_PARAMS = 1024  # floats of one image's concatenated parameters

POINTWISE = {
    "exposure", "gamma", "improved_wb", "ccm", "tone", "color", "contrast",
    "wnb", "saturation_plus",
}
SHARPEN = ("sharpen", "sharpen_v2")
FUSABLE = POINTWISE | set(SHARPEN)
# op codes of the kernel's stage table (``enum Op`` in pipeline_fwd.cu)
OPS = ("exposure", "gamma", "improved_wb", "ccm", "tone", "color",
       "contrast", "wnb", "saturation_plus", "sharpen", "sharpen_v2")


def _plan(cfg, stage_names: Sequence[str]):
    """(start, end) of each stage's parameters in the per-image vector, and
    its length (at least 1).  Counts follow ``cfg`` (``curve_steps``)."""
    from adaptiveisp_tpu_torch.ops.bank import get_spec

    offsets, total = [], 0
    for name in stage_names:
        n = get_spec(cfg, name).n_params
        offsets.append((total, total + n))
        total += n
    return offsets, max(total, 1)


def fits(names: Sequence[str]) -> bool:
    """Whether one pass takes this chain of fusable stages."""
    return (len(names) <= MAX_STAGES
            and sum(nm in SHARPEN for nm in names) <= HALO_ALLOC)


def _entry():
    fn = build.load("pipeline_fwd").pipeline_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                       + [ctypes.POINTER(ctypes.c_int)] * 3
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def pack_params(cfg, img, stages: Sequence[Tuple[str, torch.Tensor]]):
    """Each stage's parameters broadcast to [N, n_params] and concatenated:
    [N, P] float32, contiguous, on ``img``'s device (a stage given [1, n]
    serves every image)."""
    n = img.shape[0]
    offsets, total = _plan(cfg, [s[0] for s in stages])
    if not stages:
        return torch.zeros((n, 1), dtype=torch.float32, device=img.device)
    parts = []
    for (_, p), (lo, hi) in zip(stages, offsets):
        p = torch.as_tensor(p, dtype=torch.float32, device=img.device)
        p = p.reshape(p.shape[0] if p.dim() else 1, -1)
        parts.append(p.expand(n, hi - lo))
    return torch.cat(parts, dim=1).contiguous()


def render_pipeline_fused(cfg, img, stages: Sequence[Tuple[str, torch.Tensor]]):
    """Launch K4: one pass of the (name, squashed params) chain over img
    [N, H, W, 3] float32, contiguous, on a CUDA device; any N, H and W.
    Each stage's params broadcast to [N, n_params].  ``render_fixed``'s
    chain semantics: no clip between stages, none at the end."""
    names = [s[0] for s in stages]
    bad = [nm for nm in names if nm not in FUSABLE]
    if bad:
        raise ValueError(f"stages {bad} are not fusable; fusable: "
                         f"{sorted(FUSABLE)}")
    if not fits(names):
        raise ValueError(f"one pass takes at most {MAX_STAGES} stages and "
                         f"{HALO_ALLOC} sharpen stages, got {names}")
    if not isinstance(img, torch.Tensor) or img.dim() != 4 \
            or img.shape[-1] != 3:
        raise ValueError("img must be a [N, H, W, 3] tensor")
    if not img.is_cuda:
        raise ValueError(f"img must be a CUDA tensor (got {img.device}); the "
                         "plain version is bank.render_pipeline("
                         "allow_fused=False)")
    if img.dtype != torch.float32:
        raise TypeError(f"img must be float32, got {img.dtype}")
    if not img.is_contiguous():
        raise ValueError("img must be contiguous")
    n, height, width, _ = img.shape
    if n > 65535 or -(-height // 32) > 65535:
        raise ValueError(f"grid too large for N={n}, H={height}")
    params = pack_params(cfg, img, stages)
    if params.shape[1] > MAX_PARAMS:
        raise ValueError(f"{params.shape[1]} parameters per image, the "
                         f"kernel takes {MAX_PARAMS}")
    offsets, _ = _plan(cfg, names)
    table = [(ctypes.c_int * max(len(names), 1))(*vals) for vals in (
        [OPS.index(nm) for nm in names], [lo for lo, _ in offsets],
        [hi - lo for lo, hi in offsets])]
    out = torch.empty_like(img)
    with torch.cuda.device(img.device):
        rc = _entry()(img.data_ptr(), out.data_ptr(), params.data_ptr(),
                      params.shape[1], *table, len(names), n, height, width,
                      torch.cuda.current_stream(img.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{NAME} launch failed: "
                           + ("stage table refused" if rc == -1
                              else f"cudaError {rc}"))
    build.LAUNCHES[NAME] += 1
    return out


class _FusedRun(torch.autograd.Function):
    """Forward K4; backward autograd of the eager stage chain (the JAX
    package's ``custom_vjp`` at ``ops/pallas/pipeline.py:293-315``, which
    takes the VJP of the XLA stage chain)."""

    @staticmethod
    def forward(ctx, cfg, names, img, *params):
        ctx.cfg, ctx.names = cfg, names
        ctx.save_for_backward(img, *params)
        return render_pipeline_fused(cfg, img, list(zip(names, params)))

    @staticmethod
    def backward(ctx, g):
        from adaptiveisp_tpu_torch.ops.bank import render_pipeline

        img, *params = ctx.saved_tensors
        need = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(r)
                      for t, r in zip([img, *params], need)]
            out = render_pipeline(ctx.cfg, inputs[0],
                                  list(zip(ctx.names, inputs[1:])),
                                  allow_fused=False)
            wrt = [t for t, r in zip(inputs, need) if r]
            grads = iter(torch.autograd.grad(out, wrt, g, allow_unused=True)
                         if wrt else ())
        return (None, None, *[next(grads) if r else None for r in need])


def fused_run(cfg, img, stages):
    """Differentiable fused run: forward K4, backward through the
    stage-by-stage chain (exact same math)."""
    names = tuple(s[0] for s in stages)
    params = [torch.as_tensor(s[1], dtype=torch.float32, device=img.device)
              for s in stages]
    return _FusedRun.apply(cfg, names, img.contiguous(), *params)
