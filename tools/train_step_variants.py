#!/usr/bin/env python3
"""Where a bf16 train step's time goes between code variants, in one
process on the card (``chip_smoke``'s full-width train cell: Config(),
TrainConfig(batch_size=8), YOLOv3 in bf16, batch 8 @ 512).

    PYTHONPATH=. python3 tools/train_step_variants.py     # needs one card

The step is timed (host clock around each step ending in a synchronise,
median of 10 after 2 warm-up steps) in turns as it is (a), with the
``record_function`` scopes of ``train/step.py`` replaced by null contexts
(b), and with the gated NLM through a plain ``torch.autograd.Function``
over K1 and K2 (the route before the registered operator) instead of the
operator (d): a, b, d, d, b, a, once before and once after a
``torch.profiler`` session over one step.  Then one ``cProfile`` of three
steps.  Prints one JSON line of the medians and the card's name and power
limit.  With ``--pairs N`` it runs N pairs of (a, b) and N of (a, d)
instead, each pair's order alternating, no profiler session, and prints
each pair's medians, the wins of each side and the medians over pairs.
"""

import argparse
import contextlib
import cProfile
import io
import json
import os
import pstats
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from adaptiveisp_tpu_torch.config import Config, TrainConfig  # noqa: E402
from adaptiveisp_tpu_torch.ops import denoise as td  # noqa: E402
from adaptiveisp_tpu_torch.ops.cuda import nlm as cnlm  # noqa: E402
from adaptiveisp_tpu_torch.ops.math import clip_grad_mask  # noqa: E402
from adaptiveisp_tpu_torch.train import step as step_mod  # noqa: E402


class NLMGray(torch.autograd.Function):
    """K1 forward, K2 backward, as an autograd function (no operator)."""

    @staticmethod
    def forward(ctx, rgb, h, gate, sym=False):
        u, wsum = cnlm.nlm_gray_fwd(rgb, h, gate, sym=sym)
        ctx.save_for_backward(rgb, h, gate, u, wsum)
        return torch.clamp(u, 0.0, 1.0)

    @staticmethod
    def backward(ctx, g):
        rgb, h, gate, u, wsum = ctx.saved_tensors
        v = (g * clip_grad_mask(u, 0.0, 1.0)).contiguous()
        drgb, dhh = cnlm.nlm_gray_bwd(rgb, h, gate, v, u, wsum)
        return drgb, dhh * clip_grad_mask(h, 0.0), None, None


def function_dispatch(rgb, h, gate=None):
    n = rgb.shape[0]
    gate = td.canon_gate(gate, n, rgb.device)
    return NLMGray.apply(rgb.contiguous(),
                         h.to(torch.float32).expand(n, 1).contiguous(), gate)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--pairs", type=int, default=0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_step_variants: no CUDA device", file=sys.stderr)
        return 2
    smi = cs.phase_device()
    cs.phase_build()
    operator_dispatch = td.nlm_gray_dispatch
    scope = step_mod.record_function
    cfg, tcfg = Config(), TrainConfig(batch_size=8)
    state, step, batch = cs._train_setup(cfg, tcfg, 512, 8, torch.bfloat16,
                                         "cuda")
    gen = torch.Generator(device="cuda")

    def use(variant):
        step_mod.record_function = (
            scope if variant != "b"
            else (lambda name: contextlib.nullcontext()))
        td.nlm_gray_dispatch = (function_dispatch if variant == "d"
                                else operator_dispatch)

    def timed(variant, n=10):
        use(variant)
        for _ in range(2):
            step(state, batch, gen, 0.0)
        torch.cuda.synchronize()
        ts = []
        for i in range(n):
            gen.manual_seed(i)
            t0 = time.perf_counter()
            step(state, batch, gen, 0.0)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ts))

    if args.pairs:
        out = {}
        for other in ("b", "d"):
            pairs = []
            for i in range(args.pairs):
                order = ("a", other) if i % 2 == 0 else (other, "a")
                t = {v: timed(v) for v in order}
                pairs.append([t["a"], t[other]])
            out[f"a_vs_{other}"] = {
                "pairs_ms": pairs,
                "a_faster": sum(x < y for x, y in pairs),
                f"{other}_faster": sum(y < x for x, y in pairs),
                "median_a": float(np.median([x for x, _ in pairs])),
                f"median_{other}": float(np.median([y for _, y in pairs])),
                "a_quartiles": [float(q) for q in np.percentile(
                    [x for x, _ in pairs], [25, 75])]}
        print(json.dumps(out), flush=True)
        print(smi)
        return 0
    res = {}
    for when in ("before_profiler", "after_profiler"):
        for variant in ("a", "b", "d", "d", "b", "a"):
            res.setdefault(when, {}).setdefault(variant, []).append(
                timed(variant))
        if when == "before_profiler":
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]):
                step(state, batch, gen, 0.0)
                torch.cuda.synchronize()
    print(json.dumps(res), flush=True)
    use("a")
    prof = cProfile.Profile()
    torch.cuda.synchronize()
    prof.enable()
    for _ in range(3):
        step(state, batch, gen, 0.0)
    torch.cuda.synchronize()
    prof.disable()
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(25)
    print(out.getvalue()[:6000])
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
