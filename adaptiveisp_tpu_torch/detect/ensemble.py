"""NMS ensemble over several detection models (port of
``adaptiveisp_tpu/detect/ensemble.py``): each member's decoded candidate
boxes are concatenated along the candidate axis and one NMS runs over the
union.  Members may differ in spec (depth, anchors, head count) but must
agree on the class count; the reported stride is the largest.
"""

from __future__ import annotations

from typing import Any, Sequence, Tuple

import torch
import torch.nn as nn

from adaptiveisp_tpu_torch.detect.model import (
    decode_predictions,
    model_strides,
)
from adaptiveisp_tpu_torch.detect.spec import YOLOV3_SPEC


class DetectorEnsemble(nn.Module):
    """``(model, spec)`` members run as one decoded forward."""

    def __init__(self, members: Sequence[Tuple[Any, Any]]):
        super().__init__()
        if not members:
            raise ValueError("ensemble needs at least one (model, spec) "
                             "member")
        self.models = nn.ModuleList(m for m, _ in members)
        self.specs = [s or YOLOV3_SPEC for _, s in members]
        ncs = [s["nc"] for s in self.specs]
        if len(set(ncs)) != 1:
            raise ValueError(f"Models have different class counts: {ncs}")
        self.nc = ncs[0]
        self.stride = max(max(model_strides(s)) for s in self.specs)

    def __len__(self) -> int:
        return len(self.models)

    def decoded(self, x: torch.Tensor) -> torch.Tensor:
        """Decoded candidates [N, sum_i M_i, 5 + nc] over all members, in
        member order."""
        return torch.cat([decode_predictions(m(x), s)
                          for m, s in zip(self.models, self.specs)], dim=1)
