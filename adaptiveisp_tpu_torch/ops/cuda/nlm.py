"""Gated gray NLM on the GPU: wrappers of ``csrc/nlm_fwd.cu`` (K1),
``csrc/nlm_fwd_sym.cu`` (K3) and ``csrc/nlm_bwd.cu`` (K2), and the autograd
function around them.

K1 replaces the TPU kernel ``adaptiveisp_tpu/ops/pallas/nlm.py::_nlm_kernel``,
K3 its symmetry-halved variant ``_nlm_kernel_sym`` (the same function, 60
computed offsets plus the centre), K2 their fused adjoint
``_nlm_bwd_kernel``.  K3 is selected by ``sym=True`` only, as in the JAX
package, whose entry points keep K1.  The plain PyTorch twins are
:func:`adaptiveisp_tpu_torch.ops.denoise.nlm_gray_uw` and
:func:`adaptiveisp_tpu_torch.ops.denoise.nlm_gray_bwd_plain`;
``ops.denoise.nlm_gray_dispatch`` routes CPU tensors to the plain forward
(differentiated by autograd) and CUDA tensors to :class:`NLMGray`.  The
wrappers only launch their kernels: they raise on anything else, a CPU
tensor included.
"""

from __future__ import annotations

import ctypes

import torch

from adaptiveisp_tpu_torch.ops.cuda import build
from adaptiveisp_tpu_torch.ops.math import clip_grad_mask

NAME = "nlm_gray_fwd"
SYM_NAME = "nlm_gray_fwd_sym"
BWD_NAME = "nlm_gray_bwd"


def _fwd_entry(sym: bool):
    fn = (build.load("nlm_fwd_sym").nlm_gray_fwd_sym if sym
          else build.load("nlm_fwd").nlm_gray_fwd)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _bwd_lib():
    lib = build.load("nlm_bwd")
    if lib.nlm_gray_bwd.argtypes is None:
        lib.nlm_gray_bwd.argtypes = [ctypes.c_void_p] * 8 + [
            ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.nlm_gray_bwd.restype = ctypes.c_int
        lib.nlm_gray_bwd_blocks.argtypes = [ctypes.c_int] * 2
        lib.nlm_gray_bwd_blocks.restype = ctypes.c_int
    return lib


def _check(name, t, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor (got {t.device}); "
                         "the plain versions are in ops.denoise")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, rgb on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_images(rgb, h, gate):
    """Checks shared by both kernels; returns (n, height, width)."""
    if not isinstance(rgb, torch.Tensor) or rgb.dim() != 4 \
            or rgb.shape[-1] != 3:
        raise ValueError("rgb must be a [N, H, W, 3] tensor")
    n, height, width, _ = rgb.shape
    _check("rgb", rgb, (n, height, width, 3), rgb.device)
    _check("h", h, (n, 1), rgb.device)
    _check("gate", gate, (n, 1), rgb.device)
    if n > 65535 or -(-height // 8) > 65535:
        raise ValueError(f"grid too large for N={n}, H={height}")
    return n, height, width


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def nlm_gray_fwd(rgb, h, gate, sym: bool = False):
    """Launch K1, or K3 with ``sym=True``: rgb [N, H, W, 3], h [N, 1],
    gate [N, 1], all float32, contiguous, on one CUDA device.  Returns
    (U [N, H, W, 3] unclipped, W [N, H, W, 1]).  Launches even when every
    gate is 0, since skipping would need the gates on the host."""
    n, height, width = _check_images(rgb, h, gate)
    name = SYM_NAME if sym else NAME
    u = torch.empty_like(rgb)
    wsum = torch.empty((n, height, width, 1), dtype=torch.float32,
                       device=rgb.device)
    with torch.cuda.device(rgb.device):
        rc = _fwd_entry(sym)(rgb.data_ptr(), h.data_ptr(), gate.data_ptr(),
                             u.data_ptr(), wsum.data_ptr(), n, height, width,
                             _stream(rgb.device))
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    build.LAUNCHES[name] += 1
    return u, wsum


def nlm_gray_bwd(rgb, h, gate, v, u, wsum):
    """Launch K2: the adjoint of K1 for the cotangent v = dL/dU (after the
    output clip's gradient).  rgb, h, gate as for :func:`nlm_gray_fwd`;
    v, u [N, H, W, 3] and wsum [N, H, W, 1] (K1's outputs).  Returns
    (dL/drgb [N, H, W, 3], dL/dhh [N, 1]) for hh = max(h, 0) + 1e-8; both
    are exactly 0 for an image whose gate is 0."""
    n, height, width = _check_images(rgb, h, gate)
    _check("v", v, (n, height, width, 3), rgb.device)
    _check("u", u, (n, height, width, 3), rgb.device)
    _check("wsum", wsum, (n, height, width, 1), rgb.device)
    lib = _bwd_lib()
    drgb = torch.empty_like(rgb)
    part = torch.empty((n, lib.nlm_gray_bwd_blocks(height, width)),
                       dtype=torch.float32, device=rgb.device)
    with torch.cuda.device(rgb.device):
        rc = lib.nlm_gray_bwd(rgb.data_ptr(), h.data_ptr(), gate.data_ptr(),
                              v.data_ptr(), u.data_ptr(), wsum.data_ptr(),
                              drgb.data_ptr(), part.data_ptr(), n, height,
                              width, _stream(rgb.device))
    if rc != 0:
        raise RuntimeError(f"{BWD_NAME} launch failed: cudaError {rc}")
    build.LAUNCHES[BWD_NAME] += 1
    return drgb, part.sum(dim=1, keepdim=True)


class NLMGray(torch.autograd.Function):
    """clip(U, 0, 1) of K1 (K3 with ``sym=True``), differentiated by K2 in
    both cases (the JAX package's ``custom_vjp`` pair at
    ``ops/pallas/nlm.py:248-264``): the clip and the h-relu take JAX's tie
    gradients (0.5 at an exact bound); the gate gets no gradient."""

    @staticmethod
    def forward(ctx, rgb, h, gate, sym=False):
        u, wsum = nlm_gray_fwd(rgb, h, gate, sym=sym)
        ctx.save_for_backward(rgb, h, gate, u, wsum)
        return torch.clamp(u, 0.0, 1.0)

    @staticmethod
    def backward(ctx, g):
        rgb, h, gate, u, wsum = ctx.saved_tensors
        v = (g * clip_grad_mask(u, 0.0, 1.0)).contiguous()
        drgb, dhh = nlm_gray_bwd(rgb, h, gate, v, u, wsum)
        return drgb, dhh * clip_grad_mask(h, 0.0), None, None
