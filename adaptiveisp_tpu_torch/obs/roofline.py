"""Roofline accounting: FLOPs and bytes against the card's peaks (port of
``adaptiveisp_tpu/obs/roofline.py``).

  * ``flops`` — ``torch.utils.flop_counter.FlopCounterMode`` over one
    eager call: the matrix products and convolutions (forward and
    backward), analytic counts from the shapes;
  * ``bytes`` — every aten operation's tensor inputs and outputs, summed by
    a ``TorchDispatchMode`` over the same call.  An eager, unfused count: a
    tensor read by three operations counts three times, so it bounds the
    device traffic from above (as XLA's "bytes accessed" does for the JAX
    package);
  * ``mfu_pct`` — achieved FLOP/s over the card's dense bf16 tensor-core
    peak (the MFU convention of the JAX package);
  * ``hbm_pct`` — achieved bytes/s over the HBM bandwidth;
  * ``bound`` — which roof the call sits under at its arithmetic intensity.

A registered operator (the gated NLM, ``torch.ops.adaptiveisp_tpu_torch``)
is opaque to both counters, as a Pallas call is to XLA's cost model: pass
analytic counts to :func:`utilization` directly.

Peaks are NVIDIA's public H100 data sheet (dense, without sparsity; at the
part's full power limit):

  part                            bf16 FLOP/s   HBM B/s
  H100 SXM5 ("H100 80GB HBM3")    9.89e14       3.35e12
  H100 PCIe                       7.56e14       2.0e12
  H100 NVL                        8.35e14       3.9e12
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode


@dataclasses.dataclass(frozen=True)
class Peaks:
    name: str
    flops: float      # dense bf16 tensor-core peak, FLOP/s
    hbm_bytes: float  # HBM bandwidth, bytes/s


# matched in order against the lower-cased device name
_PEAKS = (
    ("h100 nvl", Peaks("H100 NVL", 8.35e14, 3.9e12)),
    ("h100 pcie", Peaks("H100 PCIe", 7.56e14, 2.0e12)),
    ("h100 80gb hbm3", Peaks("H100 SXM5", 9.89e14, 3.35e12)),
    ("h100 sxm", Peaks("H100 SXM5", 9.89e14, 3.35e12)),
)


def device_peaks(device=None) -> Optional[Peaks]:
    """Peak table lookup by ``torch.cuda.get_device_name``; None off the
    GPU (no meaningful MFU denominator for the CPU) or for a card not in
    the table."""
    device = torch.device(device) if device is not None else None
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda")
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device).lower()
    for key, peaks in _PEAKS:
        if key in name:
            return peaks
    return None


class _ByteCounter(TorchDispatchMode):
    """Sums the bytes of every aten operation's tensor inputs and
    outputs."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten((args, kwargs, out))[0]:
            if isinstance(t, torch.Tensor):
                self.bytes += t.numel() * t.element_size()
        return out


def cost_of(fn, *args, **kwargs) -> Dict[str, float]:
    """{'flops', 'bytes'} of one eager call of ``fn`` (which runs once, with
    its side effects).  Registered operators count only their tensors'
    bytes, no FLOPs: pass analytic counts to :func:`utilization`."""
    flops = FlopCounterMode(display=False)
    nbytes = _ByteCounter()
    with flops, nbytes:
        fn(*args, **kwargs)
    return {"flops": float(flops.get_total_flops()),
            "bytes": float(nbytes.bytes)}


def utilization(dt_seconds: float, flops: float = 0.0, bytes_: float = 0.0,
                device=None) -> Dict[str, float]:
    """Achieved rates and roof fractions for one measured execution.

    Returns {} off the GPU.  ``bound`` is 'compute' when the call's
    arithmetic intensity (FLOPs a byte) exceeds the card's ridge point,
    else 'memory'.
    """
    peaks = device_peaks(device)
    if peaks is None or dt_seconds <= 0:
        return {}
    out: Dict[str, float] = {"device": peaks.name}
    if flops:
        out["gflops"] = round(flops / 1e9, 2)
        out["mfu_pct"] = round(100.0 * flops / dt_seconds / peaks.flops, 2)
    if bytes_:
        out["gbytes"] = round(bytes_ / 1e9, 3)
        out["hbm_pct"] = round(
            100.0 * bytes_ / dt_seconds / peaks.hbm_bytes, 2)
    if flops and bytes_:
        ridge = peaks.flops / peaks.hbm_bytes  # FLOPs a byte at the corner
        out["bound"] = "compute" if flops / bytes_ > ridge else "memory"
    return out


def section_util(fn, dt_seconds: float, *args, device=None,
                 **kwargs) -> Dict[str, float]:
    """:func:`cost_of` + :func:`utilization` in one call: the hook for a
    benchmark section."""
    cost = cost_of(fn, *args, **kwargs)
    return utilization(dt_seconds, cost.get("flops", 0.0),
                       cost.get("bytes", 0.0), device=device)
