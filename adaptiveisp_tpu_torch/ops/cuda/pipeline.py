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

A call launches K4 once and does no other device work: the kernel reads each
stage's parameters where they lie (a device pointer and a per-image stride
in its stage table), and the chain's plan and ctypes stage table are built
once per (stage names, ``cfg.curve_steps``).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Sequence, Tuple

import torch

from adaptiveisp_tpu_torch.ops.cuda import build

NAME = "pipeline_fwd"
HALO_ALLOC = 4     # sharpen stages one pass takes (its halo, in pixels)
MAX_STAGES = 16    # stages one pass takes (the kernel's stage table)
MAX_PARAMS = 1024  # floats of one image's concatenated parameters
MAX_CHAINS = 64    # chains whose stage tables are kept

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


@dataclasses.dataclass(frozen=True)
class Chain:
    """One chain's plan and the constant part of its ctypes stage table."""
    names: Tuple[str, ...]
    counts: Tuple[int, ...]   # each stage's parameters per image
    n_params: int             # their sum (at least 1)
    ops: ctypes.Array
    offs: ctypes.Array
    cnts: ctypes.Array


_CHAINS: Dict[Tuple[Tuple[str, ...], int], Chain] = {}


def chain(cfg, names: Sequence[str]) -> Chain:
    """The :class:`Chain` of these fusable stages under ``cfg``, built on
    first use and kept; raises on a stage K4 does not take and on a chain
    over its limits."""
    key = (tuple(names), cfg.curve_steps)
    found = _CHAINS.get(key)
    if found is not None:
        return found
    bad = [nm for nm in names if nm not in FUSABLE]
    if bad:
        raise ValueError(f"stages {bad} are not fusable; fusable: "
                         f"{sorted(FUSABLE)}")
    if not fits(names):
        raise ValueError(f"one pass takes at most {MAX_STAGES} stages and "
                         f"{HALO_ALLOC} sharpen stages, got {list(names)}")
    offsets, total = _plan(cfg, names)
    if total > MAX_PARAMS:
        raise ValueError(f"{total} parameters per image, the kernel takes "
                         f"{MAX_PARAMS}")
    k = max(len(names), 1)
    found = Chain(key[0], tuple(hi - lo for lo, hi in offsets), total,
                  (ctypes.c_int * k)(*[OPS.index(nm) for nm in names]),
                  (ctypes.c_int * k)(*[lo for lo, _ in offsets]),
                  (ctypes.c_int * k)(*[hi - lo for lo, hi in offsets]))
    if len(_CHAINS) >= MAX_CHAINS:
        _CHAINS.clear()
    _CHAINS[key] = found
    return found


def param_rows(stages: Sequence[Tuple[str, torch.Tensor]],
               counts: Sequence[int], n: int, device):
    """Each stage's parameters as K4 reads them: a [1, count] or [n, count]
    float32 tensor on ``device`` whose rows have unit stride, and the floats
    between two images' rows (0 where one row serves every image).  A
    tensor that already has that layout is read where it lies, a broadcast
    row (stride 0) included; any other is made contiguous float32.  Returns
    (tensors, strides)."""
    rows, strides = [], []
    for (name, p), cnt in zip(stages, counts):
        if not isinstance(p, torch.Tensor):
            p = torch.as_tensor(p, dtype=torch.float32, device=device)
        elif p.device != device:
            raise ValueError(f"{name} parameters on {p.device}, img on "
                             f"{device}")
        if p.dim() != 2:
            p = p.reshape(p.shape[0] if p.dim() else 1, -1)
        m, c = p.shape
        if c != cnt or m not in (1, n):
            raise ValueError(f"{name} parameters {(m, c)}: expected "
                             f"[1, {cnt}] or [{n}, {cnt}]")
        if p.dtype != torch.float32 or (cnt > 1 and p.stride(1) != 1):
            p = p.to(torch.float32).contiguous()
        rows.append(p)
        strides.append(p.stride(0) if m > 1 else 0)
    return rows, strides


def pack_params(cfg, img, stages: Sequence[Tuple[str, torch.Tensor]]):
    """Each stage's parameters broadcast to [N, n_params] and concatenated:
    [N, P] float32, contiguous, on ``img``'s device (a stage given [1, n]
    serves every image): one image's parameter row as K4 gathers it."""
    n = img.shape[0]
    offsets, _ = _plan(cfg, [s[0] for s in stages])
    if not stages:
        return torch.zeros((n, 1), dtype=torch.float32, device=img.device)
    rows, _ = param_rows(stages, [hi - lo for lo, hi in offsets], n,
                         img.device)
    return torch.cat([p.expand(n, -1) for p in rows], dim=1).contiguous()


def _entry():
    fn = build.load(NAME).pipeline_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 2
                       + [ctypes.POINTER(ctypes.c_int)] * 3
                       + [ctypes.POINTER(ctypes.c_void_p),
                          ctypes.POINTER(ctypes.c_int)]
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def launch_args(cfg, img, stages: Sequence[Tuple[str, torch.Tensor]]):
    """K4's C arguments for one pass of ``stages`` over ``img`` ([N, H, W,
    3] float32, contiguous, on one CUDA device) into a new output tensor.
    Returns (args, output, the parameter tensors the arguments point
    into)."""
    ch = chain(cfg, [s[0] for s in stages])
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
    if n > 65535:
        raise ValueError(f"a pass takes at most 65535 images, got {n}")
    rows, strides = param_rows(stages, ch.counts, n, img.device)
    out = torch.empty_like(img)
    k = max(len(ch.names), 1)
    args = (img.data_ptr(), out.data_ptr(), ch.ops, ch.offs, ch.cnts,
            (ctypes.c_void_p * k)(*[p.data_ptr() for p in rows]),
            (ctypes.c_int * k)(*strides), len(ch.names), n, height, width,
            torch.cuda.current_stream(img.device).cuda_stream)
    return args, out, rows


def render_pipeline_fused(cfg, img, stages: Sequence[Tuple[str, torch.Tensor]]):
    """Launch K4: one pass of the (name, squashed params) chain over img
    [N, H, W, 3] float32, contiguous, on a CUDA device; any N, H and W.
    Each stage's params [1, n] or [N, n] (or reshapeable to that), on the
    image's device.  ``render_fixed``'s chain semantics: no clip between
    stages, none at the end."""
    args, out, _ = launch_args(cfg, img, stages)
    with torch.cuda.device(img.device):
        rc = _entry()(*args)
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
    stage-by-stage chain (exact same math).  Without a gradient to take
    (grad mode off, or no input that requires one) K4 is launched
    directly."""
    names = tuple(s[0] for s in stages)
    params = [torch.as_tensor(s[1], dtype=torch.float32, device=img.device)
              for s in stages]
    img = img.contiguous()
    if torch.is_grad_enabled() and (
            img.requires_grad or any(p.requires_grad for p in params)):
        return _FusedRun.apply(cfg, names, img, *params)
    return render_pipeline_fused(cfg, img, list(zip(names, params)))
