"""Numeric settings of a run: the program's as the configuration states
them, the reference's (float32, TF32 off) and the control's (the
reference one precision lower: TF32), and the model FLOPs of a call."""

from __future__ import annotations

import contextlib
from typing import Callable, Dict

import torch


def _tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def program(settings: Dict) -> None:
    """The configuration's settings for the program's side; cuDNN picks its
    algorithms by heuristics (no autotuning)."""
    _tf32(bool(settings.get("tf32", False)))
    torch.backends.cudnn.benchmark = False


@contextlib.contextmanager
def _flags(tf32: bool):
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    _tf32(tf32)
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def reference():
    return _flags(tf32=False)


def control():
    return _flags(tf32=True)


def count_flops(fn: Callable) -> float:
    """Matrix-product and convolution FLOPs of ``fn()`` (forward and, where
    ``fn`` runs one, backward), from the shapes."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return float(counter.get_total_flops())
