"""Non-local-means denoising (port of ``adaptiveisp_tpu/ops/denoise.py``).

:func:`nlm_gray` is the plain PyTorch version: 121 circular ``torch.roll``
shifts with a separable 5x5 box sum, the JAX package's eager chain.  With
:func:`nlm_gray_bwd_plain` (its adjoint, written out) it is the twin of the
CUDA kernels in :mod:`adaptiveisp_tpu_torch.ops.cuda.nlm`;
:func:`nlm_gray_dispatch` picks between the two by the tensor's device.

The reference's other two variants are plain PyTorch here, as they are
plain XLA in the JAX package: :func:`nlm_rgb` (``NonLocalMeans``: RGB
distances, circular boundaries) and :func:`nlm_param` (``NonLocalMeansParam``:
reflect boundaries, one learnable strength).  Both walk their offsets one
search row at a time, each row under activation checkpointing when a
gradient is wanted, so memory stays a few images whatever the window.

All tensors are NHWC float32 in [0, 1]; ``h`` (filter strength) is [N, 1].
"""

from __future__ import annotations

import torch

from adaptiveisp_tpu_torch.ops.math import (
    clip,
    clip_grad_mask,
    rgb_to_luminance,
)

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


def box_mean(x, window_size: int):
    return box_sum(x, window_size) / float(window_size * window_size)


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
    unclipped (U, W) chain for the cotangent v on U, written out offset by
    offset in the forward's order (no autograd, so it also runs inside a
    registered operator's kernel, below autograd and under any dispatch
    mode).

    Returns (dL/drgb [N, H, W, 3], dL/dhh [N, 1]) for hh = relu(h) + eps;
    gated-off images get exactly 0.  ``u`` and ``wsum`` are the forward's
    outputs (recomputed when not given).  With a = v / W and
    q = -(sum_c v_c U_c) / W, each offset d with weight w = exp(-s / hh),
    s = sqrt(b), b = box5((y - S_d y)^2), adds S_-d(w a) to dL/drgb,
    g = a . S_d rgb + q times w s / hh^2 to dL/dhh, and through
    db = -g w / (2 hh s) (0 where b = 0) the luminance adjoint
    Z - S_-d Z, Z = 2 (y - S_d y) box5(db); the luminance's clip takes
    JAX's tie gradient.
    """
    n = rgb.shape[0]
    on = canon_gate(gate, n, rgb.device) != 0
    rgb, v = rgb.detach(), v.detach()
    hh = (clip(h.detach(), 0.0) + EPS)[:, None, None, :]
    if u is None or wsum is None:
        u, wsum = _nlm_uw_hh(rgb, hh)
    r, y = 5, rgb_to_luminance(rgb)
    a = v / wsum
    q = -(v * u).sum(-1, keepdim=True) / wsum
    drgb, dy, dhh = torch.zeros_like(rgb), torch.zeros_like(y), 0.0
    for dx in range(-r, r + 1):
        for dyy in range(-r, r + 1):
            diff = y - torch.roll(y, (dyy, dx), dims=(1, 2))
            b = box_sum(diff * diff, 5)
            pos = b > 0.0
            dist = _safe_sqrt(b)
            w = torch.exp(-dist / hh)
            g = (a * torch.roll(rgb, (dyy, dx), dims=(1, 2))).sum(
                -1, keepdim=True) + q
            drgb = drgb + torch.roll(a * w, (-dyy, -dx), dims=(1, 2))
            gw = g * w
            dhh = dhh + (gw * dist).sum((1, 2, 3), keepdim=True)
            db = torch.where(pos, -0.5 * gw / (
                hh * torch.where(pos, dist, torch.ones_like(dist))), 0.0)
            z = 2.0 * diff * box_sum(db, 5)
            dy = dy + z - torch.roll(z, (-dyy, -dx), dims=(1, 2))
    lum = torch.tensor([0.299, 0.587, 0.114], dtype=rgb.dtype,
                       device=rgb.device)
    drgb = drgb + dy * lum * clip_grad_mask(rgb, 0.0, 1.0)
    dhh = dhh / (hh * hh)
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
    """Gated gray NLM through the registered operator
    ``adaptiveisp_tpu_torch::nlm_gray`` (``ops.cuda.nlm``): the CUDA kernels
    for a CUDA tensor, the plain version for a CPU tensor.

    h: [N, 1], or [1, 1] for one strength shared by every image (a fixed
    pipeline's parameter; expanded to [N, 1], so it gets the sum of the
    images' gradients).  gate: optional [N] / [N, 1] blend weights.  Images
    whose gate is exactly 0 return zeros, and neither route computes them:
    the kernel skips their work, the plain version runs on the other images
    alone (each image's result depends on that image only).  Both are
    differentiable: K1 forward and K2 backward on the card, autograd of the
    plain chain on the CPU.
    """
    from adaptiveisp_tpu_torch.ops.cuda.nlm import nlm_gray as nlm_gray_k

    n = rgb.shape[0]
    return nlm_gray_k(rgb.contiguous(),
                      h.to(torch.float32).expand(n, 1).contiguous(),
                      canon_gate(gate, n, rgb.device))


def _by_rows(row_fn, n_rows: int, acc, *args):
    """acc = row_fn(r, *acc, *args) for r in range(n_rows): a search
    window's offsets one row at a time, accumulated in order.  With a
    gradient wanted each row is recomputed in the backward (checkpointing),
    so only the accumulators are kept between rows."""
    from torch.utils.checkpoint import checkpoint

    grad = torch.is_grad_enabled() and any(
        torch.is_tensor(t) and t.requires_grad for t in acc + args)
    for r in range(n_rows):
        acc = (checkpoint(row_fn, r, *acc, *args, use_reentrant=False)
               if grad else row_fn(r, *acc, *args))
    return acc


def _pad_reflect(x, pad: int):
    """NHWC ``x`` padded by ``pad`` on H and W with numpy's (and
    ``jnp.pad``'s) ``reflect`` mode, repeated reflection included."""
    for dim in (1, 2):
        n = x.shape[dim]
        i = torch.arange(-pad, n + pad, device=x.device)
        if n == 1:
            i = torch.zeros_like(i)
        else:
            period = 2 * (n - 1)
            i = torch.remainder(i, period)
            i = torch.where(i >= n, period - i, i)
        x = torch.index_select(x, dim, i)
    return x


def _box_sum_reflect(x, window_size: int):
    """Box sum over H, W with a REFLECT boundary (the unfold variant's,
    reference denoise.py:150-153): pad once, then ``window_size`` row
    slices and as many column slices, in the JAX package's order."""
    pad = (window_size - 1) // 2
    h, w = x.shape[1], x.shape[2]
    xp = _pad_reflect(x, pad)
    row = xp[:, 0:h]
    for i in range(1, window_size):
        row = row + xp[:, i:i + h]
    out = row[:, :, 0:w]
    for j in range(1, window_size):
        out = out + row[:, :, j:j + w]
    return out


def nlm_param(rgb, h, search_window_size: int = 21):
    """Learnable-strength unfold NLM (reference NonLocalMeansParam,
    denoise.py:122-181), as the JAX package's:
      * REFLECT boundaries, not circular rolls;
      * each offset's squared luminance difference is aggregated over the
        whole *search* window (the reference's second ``unfold``), not a
        patch;
      * ``h`` is one strength (a scalar or [1] tensor, which may require
        a gradient: an optimizer owns it).

    rgb: [N, H, W, 3].  Returns [N, H, W, 3] in [0, 1].  JAX stacks all
    ws^2 offsets ([N, H, W, 441] at ws 21); here each search row's ws
    offsets are stacked and reduced before the next row.
    """
    ws = search_window_size
    pad = (ws - 1) // 2
    height, width = rgb.shape[1], rgb.shape[2]
    y = rgb_to_luminance(rgb)
    y_pad = _pad_reflect(y, pad)
    rgb_pad = _pad_reflect(rgb, pad)
    hh = clip(torch.as_tensor(h, dtype=rgb.dtype, device=rgb.device)
              .reshape(()), 0.0) + EPS

    def row(dy, denoised, weights, y, y_pad, rgb_pad, hh):
        dis0 = torch.cat([(y - y_pad[:, dy:dy + height, dx:dx + width]) ** 2
                          for dx in range(ws)], dim=-1)        # [N,H,W,ws]
        w = torch.exp(-_safe_sqrt(_box_sum_reflect(dis0, ws)) / hh)
        for dx in range(ws):
            denoised = denoised + (
                w[..., dx:dx + 1] * rgb_pad[:, dy:dy + height, dx:dx + width])
        return denoised, weights + w.sum(-1, keepdim=True)

    denoised, weights = _by_rows(
        row, ws, (torch.zeros_like(rgb), torch.zeros_like(y)),
        y, y_pad, rgb_pad, hh)
    return clip(denoised / weights, 0.0, 1.0)


def nlm_rgb(rgb, h, search_window_size: int = 21, patch_size: int = 7):
    """RGB-distance non-local means (reference NonLocalMeans, :68-90):
    circular boundaries, each channel weighted by its own patch distance.
    rgb: [N, H, W, 3]; h: [N, 1]."""
    r = search_window_size // 2
    hh = clip(h, 0.0)[:, None, None, :] + EPS

    def row(i, denoised, weights, rgb, hh):
        dx = i - r
        for dy in range(-r, r + 1):
            shifted = torch.roll(rgb, (dy, dx), dims=(1, 2))
            w = torch.exp(-_safe_sqrt(box_sum((rgb - shifted) ** 2,
                                              patch_size)) / hh)
            denoised = denoised + shifted * w
            weights = weights + w
        return denoised, weights

    denoised, weights = _by_rows(
        row, 2 * r + 1, (torch.zeros_like(rgb), torch.zeros_like(rgb)),
        rgb, hh)
    return clip(denoised / weights, 0.0, 1.0)
