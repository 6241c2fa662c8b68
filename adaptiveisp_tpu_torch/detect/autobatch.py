"""Batch size from device memory (port of
``adaptiveisp_tpu/detect/autobatch.py``).

The JAX package reads the compiled step's bytes from XLA; here the memory is
measured, as the reference autobatch (utils/autobatch.py) does: a few trial
train steps at small batch sizes, the peak of ``torch.cuda.
max_memory_allocated`` after each, a straight line fitted through them, and
the largest batch whose predicted peak fits ``fraction`` of the card's
memory (``torch.cuda.mem_get_info``), rounded down to a power of two as the
JAX package rounds.  Off a CUDA device it returns the default batch.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np
import torch

DEFAULT_BATCH = 16


def fit_batch(sizes: Sequence[int], peaks: Sequence[float],
              capacity: float, fraction: float = 0.8,
              max_batch: int = 1024) -> int:
    """Largest power-of-two batch whose line-fitted peak bytes
    ``intercept + slope * b`` stay within ``fraction * capacity``."""
    slope, intercept = np.polyfit(np.asarray(sizes, np.float64),
                                  np.asarray(peaks, np.float64), 1)
    if slope <= 0:
        return int(max(sizes))
    b = int((capacity * fraction - intercept) / slope)
    b = max(1, min(max_batch, b))
    return 2 ** int(math.log2(b))


def autobatch(step: Callable[[int], None], device=None,
              fraction: float = 0.8, probe_sizes=(1, 2, 4, 8),
              max_batch: int = 1024, default: int = DEFAULT_BATCH,
              verbose: bool = True) -> int:
    """``step(b)`` runs one trial at batch b on ``device``; returns the
    batch size (``default`` off a CUDA device)."""
    device = torch.device(device or "cuda")
    if device.type != "cuda":
        if verbose:
            print(f"autobatch: {device} has no memory statistics; "
                  f"batch {default}")
        return default
    peaks = []
    for b in probe_sizes:
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        step(b)
        torch.cuda.synchronize(device)
        peaks.append(torch.cuda.max_memory_allocated(device))
    _, total = torch.cuda.mem_get_info(device)
    b = fit_batch(probe_sizes, peaks, total, fraction, max_batch)
    if verbose:
        slope, intercept = np.polyfit(probe_sizes, peaks, 1)
        print(f"autobatch: peak(b) ~ {intercept / 1e6:.1f} MB + "
              f"{slope / 1e6:.2f} MB/img over b = {list(probe_sizes)}; "
              f"capacity {total / 1e9:.1f} GB x {fraction:.0%} -> batch {b}")
    return b


def autobatch_detector(model, spec, imgsz: int = 640, fraction: float = 0.8,
                       device=None, probe_sizes=(1, 2, 4, 8),
                       default: int = DEFAULT_BATCH,
                       verbose: bool = True) -> int:
    """The reference's check_train_batch_size for a ``DetectionModel``:
    trial train steps (train-mode forward, ``batch_loss`` on one box an
    image, backward) at ``probe_sizes``; the model's weights and
    statistics are restored afterwards."""
    from adaptiveisp_tpu_torch.detect.loss import LossHyp, batch_loss
    from adaptiveisp_tpu_torch.detect.model import anchors_in_grid_units

    device = torch.device(device or next(model.parameters()).device)
    model = model.to(device)
    saved = {k: v.detach().clone() for k, v in model.state_dict().items()}
    anchors = anchors_in_grid_units(spec)
    was_training = model.training

    def step(b):
        model.train()
        x = torch.rand(b, imgsz, imgsz, 3, device=device)
        t = torch.tensor([[0.0, 0.5, 0.5, 0.2, 0.2]],
                         device=device).expand(b, 1, 5).contiguous()
        m = torch.ones(b, 1, dtype=torch.bool, device=device)
        loss, _ = batch_loss(model(x), t, m, anchors, LossHyp())
        loss.backward()
        model.zero_grad(set_to_none=True)

    try:
        return autobatch(step, device, fraction, probe_sizes,
                         default=default, verbose=verbose)
    finally:
        model.load_state_dict(saved)
        model.train(was_training)
