"""Gated gray NLM on the GPU: wrappers of ``csrc/nlm_fwd.cu`` (K1) and
``csrc/nlm_bwd.cu`` (K2), and the registered operators around them.

K1 replaces the TPU kernel ``adaptiveisp_tpu/ops/pallas/nlm.py::_nlm_kernel``
and its symmetry-halved variant ``_nlm_kernel_sym`` (K3): the two compute
one function, and K1 is built the symmetric way, 60 offset pairs plus the
centre (w_{-d}(p) = w_d(p - d)).  So ``sym`` is kept, as JAX's
``nlm_gray_pallas(sym=)`` has it, and both of its values launch K1.  K2
replaces their fused adjoint ``_nlm_bwd_kernel``.  The plain PyTorch twins
are :func:`adaptiveisp_tpu_torch.ops.denoise.nlm_gray_uw` and
:func:`adaptiveisp_tpu_torch.ops.denoise.nlm_gray_bwd_plain`.

``torch.ops.adaptiveisp_tpu_torch.nlm_gray`` (:func:`nlm_gray_op`) is the
one route to K1: a registered operator whose CUDA route launches K1, whose
CPU kernel is the plain version, whose fake tensors build and launch
nothing, and whose backward is a second operator, ``nlm_gray_bwd`` (K2 on
the card, the plain chain's adjoint on the CPU).  Being opaque, it is one
node in a ``torch.export`` program (``detect/export.py``), so such a
program launches K1 on the card and runs the plain version on the CPU.
``ops.denoise.nlm_gray_dispatch`` calls it on both devices.  The wrappers
:func:`nlm_gray_fwd` and :func:`nlm_gray_bwd` only launch their kernels:
they raise on anything else, a CPU tensor included.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from adaptiveisp_tpu_torch.ops.cuda import build
from adaptiveisp_tpu_torch.ops.math import clip_grad_mask

NAME = "nlm_gray_fwd"
BWD_NAME = "nlm_gray_bwd"


def _fwd_entry():
    fn = build.load("nlm_fwd").nlm_gray_fwd
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
    """Launch K1: rgb [N, H, W, 3], h [N, 1], gate [N, 1], all float32,
    contiguous, on one CUDA device.  Returns (U [N, H, W, 3] unclipped,
    W [N, H, W, 1]).  ``sym`` (JAX's K3) launches the same kernel: K1 is
    the symmetry-halved forward.  Launches even when every gate is 0, since
    skipping would need the gates on the host."""
    n, height, width = _check_images(rgb, h, gate)
    u = torch.empty_like(rgb)
    wsum = torch.empty((n, height, width, 1), dtype=torch.float32,
                       device=rgb.device)
    with torch.cuda.device(rgb.device):
        rc = _fwd_entry()(rgb.data_ptr(), h.data_ptr(), gate.data_ptr(),
                          u.data_ptr(), wsum.data_ptr(), n, height, width,
                          _stream(rgb.device))
    if rc != 0:
        raise RuntimeError(f"{NAME} launch failed: cudaError {rc}")
    build.LAUNCHES[NAME] += 1
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


# --------------------------------------------------------------------------- #
# the registered operators: one opaque node per call for autograd, fake
# tensors and ``torch.export``
# --------------------------------------------------------------------------- #
Tensor = torch.Tensor


def _gated_on(gate):
    return (gate.reshape(-1) != 0).nonzero()[:, 0]


@torch.library.custom_op("adaptiveisp_tpu_torch::nlm_gray", mutates_args=())
def nlm_gray_op(rgb: Tensor, h: Tensor, gate: Tensor,
                sym: bool = False) -> Tuple[Tensor, Tensor, Tensor]:
    """Gated gray NLM as one operator: rgb [N, H, W, 3], h [N, 1], gate
    [N, 1], float32.  Returns (clip(U, 0, 1), U, W); U and W are the
    residuals that K2 reads, zero for a gated-off image, and take no
    gradient.  A CUDA tensor launches K1 (this default route raises on any
    other device); a CPU tensor runs the plain version on the gated-on
    images only.  The JAX package's ``custom_vjp`` pair at
    ``ops/pallas/nlm.py:248-264``: the clip and the h-relu take JAX's tie
    gradients (0.5 at an exact bound); the gate gets no gradient."""
    u, wsum = nlm_gray_fwd(rgb, h, gate, sym=sym)
    return torch.clamp(u, 0.0, 1.0), u, wsum


@nlm_gray_op.register_kernel("cpu")
def _nlm_gray_cpu(rgb, h, gate, sym=False):
    from adaptiveisp_tpu_torch.ops.denoise import nlm_gray_uw

    u = torch.zeros_like(rgb)
    wsum = rgb.new_zeros(rgb.shape[:3] + (1,))
    idx = _gated_on(gate)
    if idx.numel():
        u_on, w_on = nlm_gray_uw(rgb[idx], h[idx])
        u, wsum = u.index_copy(0, idx, u_on), wsum.index_copy(0, idx, w_on)
    return torch.clamp(u, 0.0, 1.0), u, wsum


@nlm_gray_op.register_fake
def _nlm_gray_fake(rgb, h, gate, sym=False):
    return (torch.empty_like(rgb), torch.empty_like(rgb),
            rgb.new_empty(rgb.shape[:3] + (1,)))


@torch.library.custom_op("adaptiveisp_tpu_torch::nlm_gray_bwd",
                         mutates_args=())
def nlm_gray_bwd_op(rgb: Tensor, h: Tensor, gate: Tensor, v: Tensor,
                    u: Tensor, wsum: Tensor) -> Tuple[Tensor, Tensor]:
    """(dL/drgb, dL/dhh) of U for the cotangent v: K2 for a CUDA tensor,
    the plain chain's adjoint (``ops.denoise.nlm_gray_bwd_plain``) on the
    gated-on images for a CPU tensor."""
    return nlm_gray_bwd(rgb, h, gate, v, u, wsum)


@nlm_gray_bwd_op.register_kernel("cpu")
def _nlm_gray_bwd_cpu(rgb, h, gate, v, u, wsum):
    from adaptiveisp_tpu_torch.ops.denoise import nlm_gray_bwd_plain

    drgb, dhh = torch.zeros_like(rgb), torch.zeros_like(h)
    idx = _gated_on(gate)
    if idx.numel():
        dr_on, dh_on = nlm_gray_bwd_plain(rgb[idx], h[idx], gate[idx],
                                          v[idx], u[idx], wsum[idx])
        drgb, dhh = drgb.index_copy(0, idx, dr_on), dhh.index_copy(
            0, idx, dh_on)
    return drgb, dhh


@nlm_gray_bwd_op.register_fake
def _nlm_gray_bwd_fake(rgb, h, gate, v, u, wsum):
    return torch.empty_like(rgb), torch.empty_like(h)


def _setup_context(ctx, inputs, output):
    rgb, h, gate, _ = inputs
    _, u, wsum = output
    ctx.save_for_backward(rgb, h, gate, u, wsum)
    ctx.mark_non_differentiable(u, wsum)


def _backward(ctx, g, _gu, _gw):
    rgb, h, gate, u, wsum = ctx.saved_tensors
    v = (g * clip_grad_mask(u, 0.0, 1.0)).contiguous()
    drgb, dhh = nlm_gray_bwd_op(rgb, h, gate, v, u, wsum)
    return drgb, dhh * clip_grad_mask(h, 0.0), None, None


nlm_gray_op.register_autograd(_backward, setup_context=_setup_context)


def nlm_gray(rgb, h, gate, sym: bool = False):
    """clip(U, 0, 1) of :func:`nlm_gray_op`, differentiable in rgb and h."""
    return nlm_gray_op(rgb, h, gate, sym)[0]
