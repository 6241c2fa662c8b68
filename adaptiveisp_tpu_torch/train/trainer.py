"""Trainer-level helpers (port of part of
``adaptiveisp_tpu/train/trainer.py``; the ``Trainer`` loop, replay pool and
datasets come with the next slice)."""

from __future__ import annotations

from adaptiveisp_tpu_torch.detect.loss import LossHyp


def imgsz_hyp(imgsz: int, nc: int = 80, nl: int = 3) -> LossHyp:
    """The trainer's hyp scaling: box *= 3/nl, cls *= nc/80 * 3/nl,
    obj *= (imgsz/640)^2 * 3/nl."""
    return LossHyp(box=0.05 * 3 / nl,
                   cls=0.5 * nc / 80 * 3 / nl,
                   obj=1.0 * (imgsz / 640) ** 2 * 3 / nl)
