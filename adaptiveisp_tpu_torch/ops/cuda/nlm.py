"""Gated gray NLM forward on the GPU: wrapper of ``csrc/nlm_fwd.cu``.

Replaces the TPU kernel ``adaptiveisp_tpu/ops/pallas/nlm.py::_nlm_kernel``.
The plain PyTorch twin is :func:`adaptiveisp_tpu_torch.ops.denoise.nlm_gray`
(plus the gate mask); ``ops.denoise.nlm_gray_dispatch`` routes CPU tensors
there and CUDA tensors here.  This wrapper only launches the kernel: it
raises on anything else, a CPU tensor included.
"""

from __future__ import annotations

import ctypes

import torch

from adaptiveisp_tpu_torch.ops.cuda import build

NAME = "nlm_gray_fwd"


def _entry():
    fn = build.load("nlm_fwd").nlm_gray_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(name, t, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor (got {t.device}); "
                         "the plain version is ops.denoise.nlm_gray")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, rgb on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def nlm_gray_fwd(rgb, h, gate):
    """Launch the kernel: rgb [N, H, W, 3], h [N, 1], gate [N, 1], all
    float32, contiguous, on one CUDA device.  Returns (U [N, H, W, 3]
    unclipped, W [N, H, W, 1]).  Launches even when every gate is 0, since
    skipping would need the gates on the host."""
    if not isinstance(rgb, torch.Tensor) or rgb.dim() != 4 \
            or rgb.shape[-1] != 3:
        raise ValueError("rgb must be a [N, H, W, 3] tensor")
    n, height, width, _ = rgb.shape
    _check("rgb", rgb, (n, height, width, 3), rgb.device)
    _check("h", h, (n, 1), rgb.device)
    _check("gate", gate, (n, 1), rgb.device)
    if n > 65535 or -(-height // 8) > 65535:
        raise ValueError(f"grid too large for N={n}, H={height}")
    u = torch.empty_like(rgb)
    wsum = torch.empty((n, height, width, 1), dtype=torch.float32,
                       device=rgb.device)
    with torch.cuda.device(rgb.device):
        stream = torch.cuda.current_stream(rgb.device).cuda_stream
        rc = _entry()(rgb.data_ptr(), h.data_ptr(), gate.data_ptr(),
                      u.data_ptr(), wsum.data_ptr(), n, height, width, stream)
    if rc != 0:
        raise RuntimeError(f"{NAME} launch failed: cudaError {rc}")
    build.LAUNCHES[NAME] += 1
    return u, wsum


def nlm_gray_cuda(rgb, h, gate):
    """The op: clip(U, 0, 1), with gated-off images exactly 0."""
    u, _ = nlm_gray_fwd(rgb, h, gate)
    return torch.clamp(u, 0.0, 1.0)
