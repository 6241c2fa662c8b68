"""Device calls that a run makes on the card and skips on the CPU (where
the benchmark's own tests drive a run at a tiny size)."""

from __future__ import annotations

import statistics
import sys
import time

import torch


def is_card(device) -> bool:
    return torch.device(device).type == "cuda"


def sync(device) -> None:
    if is_card(device):
        torch.cuda.synchronize(device)


def reset_peak(device) -> None:
    if is_card(device):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if is_card(
        device) else 0


def name(device) -> str:
    return torch.cuda.get_device_name(device) if is_card(device) else "cpu"


def free(device) -> None:
    if is_card(device):
        torch.cuda.empty_cache()


def host_buffer(like: torch.Tensor, device) -> torch.Tensor:
    """A host copy of ``like``, pinned when it feeds a card."""
    out = torch.empty(like.shape, dtype=like.dtype, pin_memory=is_card(device))
    out.copy_(like)
    return out


class Phases:
    """Seconds of each set-up phase, printed on standard error."""

    def __init__(self, started: float):
        self.last = started
        self.seconds = {}

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = now - self.last
        self.last = now

    def report(self) -> None:
        print("setup " + " ".join(f"{k}={v:.2f}s"
                                  for k, v in self.seconds.items()),
              file=sys.stderr, flush=True)


def spread_report(what: str, seconds) -> None:
    """Quartiles and extremes of per-unit times (in the order they ran),
    their mean, and the share of their sum spent in units over twice the
    median, over all and over each half, on standard error."""
    if len(seconds) < 4:
        return
    ms = [x * 1e3 for x in seconds]
    q = statistics.quantiles(ms, n=4)

    def slow(part):
        return sum(x for x in part if x > 2 * q[1]) / sum(part)

    half = len(ms) // 2
    print(f"{what} ms: n={len(ms)} min={min(ms):.1f} q1={q[0]:.1f} "
          f"median={q[1]:.1f} q3={q[2]:.1f} max={max(ms):.1f} "
          f"mean={statistics.fmean(ms):.1f} over_2x_median_share="
          f"{slow(ms):.4f} (first half {slow(ms[:half]):.4f}, second half "
          f"{slow(ms[half:]):.4f})", file=sys.stderr, flush=True)
