"""Non-local-means denoising (port of ``adaptiveisp_tpu/ops/denoise.py``).

:func:`nlm_gray` is the plain PyTorch version: 121 circular ``torch.roll``
shifts with a separable 5x5 box sum, the JAX package's eager chain.  With
:func:`nlm_gray_bwd_plain` (its adjoint, by autograd) it is the twin of the
CUDA kernels in :mod:`adaptiveisp_tpu_torch.ops.cuda.nlm`;
:func:`nlm_gray_dispatch` picks between the two by the tensor's device.

All tensors are NHWC float32 in [0, 1]; ``h`` (filter strength) is [N, 1].
"""

from __future__ import annotations

import torch

from adaptiveisp_tpu_torch.ops.math import clip, rgb_to_luminance

EPS = 1e-8


def box_sum(x, window_size: int):
    """Circular box sum over the H, W axes of an NHWC tensor (rows, then
    columns)."""
    r = window_size // 2
    row = torch.zeros_like(x)
    for dy in range(-r, r + 1):
        row = row + torch.roll(x, dy, dims=1)
    out = torch.zeros_like(x)
    for dx in range(-r, r + 1):
        out = out + torch.roll(row, dx, dims=2)
    return out


def _safe_sqrt(x):
    """sqrt with zero value and zero gradient where x <= 0 (the double
    ``where`` keeps the gradient finite at the zero-distance centre)."""
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, torch.ones_like(x))),
                       torch.zeros_like(x))


def nlm_gray(rgb, h, search_window_size: int = 11, patch_size: int = 5):
    """Gray-guided non-local means, circular boundaries.

    rgb: [N, H, W, 3]; h: [N, 1].  Distances on the luminance of the clipped
    image; weights ``exp(-sqrt(relu(boxsum((y - y')^2))) / (relu(h) + eps))``.
    Returns the clipped ratio.
    """
    u, _ = nlm_gray_uw(rgb, h, search_window_size, patch_size)
    return clip(u, 0.0, 1.0)


def nlm_gray_uw(rgb, h, search_window_size: int = 11, patch_size: int = 5):
    """:func:`nlm_gray` before the clip: (U [N, H, W, 3] unclipped ratio,
    W [N, H, W, 1] weight sum), what the CUDA kernel writes."""
    hh = clip(h, 0.0)[:, None, None, :] + EPS
    return _nlm_uw_hh(rgb, hh, search_window_size, patch_size)


def _nlm_uw_hh(rgb, hh, search_window_size: int = 11, patch_size: int = 5):
    """(U, W) for the strength hh = relu(h) + eps, [N, 1, 1, 1]."""
    r = search_window_size // 2
    y = rgb_to_luminance(rgb)
    weights = torch.zeros_like(y)
    denoised = torch.zeros_like(rgb)
    for dx in range(-r, r + 1):
        for dy in range(-r, r + 1):
            shifted_rgb = torch.roll(rgb, (dy, dx), dims=(1, 2))
            shifted_y = torch.roll(y, (dy, dx), dims=(1, 2))
            dist = _safe_sqrt(box_sum((y - shifted_y) ** 2, patch_size))
            w = torch.exp(-dist / hh)
            denoised = denoised + shifted_rgb * w
            weights = weights + w
    return denoised / weights, weights


def nlm_gray_bwd_plain(rgb, h, gate, v, u=None, wsum=None):
    """Plain twin of the K2 kernel, with its signature: the adjoint of the
    unclipped (U, W) chain for the cotangent v on U, by autograd.

    Returns (dL/drgb [N, H, W, 3], dL/dhh [N, 1]) for hh = relu(h) + eps;
    gated-off images get exactly 0.  ``u`` and ``wsum`` (the kernel's saved
    forward outputs) are not needed here: the chain is recomputed.
    """
    n = rgb.shape[0]
    on = canon_gate(gate, n, rgb.device) != 0
    with torch.enable_grad():
        x = rgb.detach().requires_grad_(True)
        hh = (clip(h.detach(), 0.0) + EPS)[:, None, None, :].requires_grad_(
            True)
        u_p, _ = _nlm_uw_hh(x, hh)
        drgb, dhh = torch.autograd.grad(u_p, (x, hh), v)
    return (torch.where(on.reshape(n, 1, 1, 1), drgb, 0.0),
            torch.where(on, dhh.reshape(n, 1), 0.0))


def canon_gate(gate, n: int, device):
    """[N] / [N, 1] blend weights (e.g. a one-hot column, a strided view) ->
    contiguous [N, 1] float32 with no gradient; None means every image is
    on."""
    if gate is None:
        return torch.ones((n, 1), dtype=torch.float32, device=device)
    return torch.as_tensor(gate, dtype=torch.float32,
                           device=device).detach().reshape(n, 1).contiguous()


def nlm_gray_dispatch(rgb, h, gate=None):
    """Gated gray NLM: the CUDA kernels for a CUDA tensor, the plain version
    for a CPU tensor.

    h: [N, 1], or [1, 1] for one strength shared by every image (a fixed
    pipeline's parameter).  gate: optional [N] / [N, 1] blend weights.
    Images whose gate is exactly 0 return zeros, and neither path computes
    them: the kernel skips their work, the plain version runs on the other
    images alone (each image's result depends on that image only).  Both
    are differentiable: on the card through ``NLMGray`` (K1 forward, K2
    backward; a shared strength gets the sum of the images' gradients), on
    the CPU by autograd of the plain chain.
    """
    n = rgb.shape[0]
    gate = canon_gate(gate, n, rgb.device)
    if rgb.is_cuda:
        from adaptiveisp_tpu_torch.ops.cuda.nlm import NLMGray

        return NLMGray.apply(rgb.contiguous(),
                             h.to(torch.float32).expand(n, 1).contiguous(),
                             gate)
    out = torch.zeros_like(rgb)
    idx = (gate.reshape(n) != 0).nonzero()[:, 0]
    if idx.numel():
        out = out.index_copy(0, idx, nlm_gray(
            rgb[idx], h if h.shape[0] == 1 else h[idx]))
    return out
