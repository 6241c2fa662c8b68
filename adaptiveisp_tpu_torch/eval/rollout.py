"""Adaptive ISP rollout (port of ``adaptiveisp_tpu/eval/rollout.py``).

A Python loop over the steps with a stop mask per sample: once a sample's
stopped bit is set its image and state stop updating and its selection reads
-1.  With ``early_exit`` the loop skips the agent entirely once every sample
has stopped (one host read of the stop mask per step).  Spans (only while a
profiler records, ``obs/profile.py``): ``rollout`` around the loop,
``rollout.step`` around each step and ``rollout.stop_read`` around the read,
counted as ``host_read.rollout``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from adaptiveisp_tpu_torch.obs.profile import count, span
from adaptiveisp_tpu_torch.ops.bank import param_offsets
from adaptiveisp_tpu_torch.policy.states import STATE_STOPPED_DIM


class RolloutResult(NamedTuple):
    image: torch.Tensor          # [N, H, W, 3] final retouched image
    states: torch.Tensor         # [N, S] final states
    high_res: Optional[torch.Tensor]
    selected: torch.Tensor       # [steps, N] filter ids, -1 once stopped
    pdfs: torch.Tensor           # [steps, N, K]
    images_per_step: Optional[torch.Tensor]  # [steps, N, H, W, 3] if recorded
    params: Optional[torch.Tensor] = None    # [steps, N, sum(n_params)]


def no_pipeline(steps: int):
    return [-1] * steps


def _all_stopped(stop) -> bool:
    """The host read of the stop mask."""
    with span("rollout.stop_read"):
        count("host_read.rollout")
        return bool((stop > 0).all())


@torch.no_grad()
def rollout(agent, image, noises, states, pipeline: Sequence[int],
            record_steps: bool = False, render: str = "blend",
            early_exit: bool = True) -> RolloutResult:
    """Run ``len(noises)`` agent steps in eval mode.

    image [N, H, W, 3]; noises [steps, N, z_dim]; states [N, S]; pipeline:
    one int per step, the forced filter id or -1 for the agent's choice.
    Early exit is off when recording steps, whose consumers read the pdfs of
    every step.
    """
    steps, n = noises.shape[0], image.shape[0]
    pipeline = [int(p) for p in pipeline]
    if len(pipeline) != steps:
        raise ValueError(f"pipeline has {len(pipeline)} entries, "
                         f"noises {steps} steps")
    early_exit = early_exit and not record_steps
    n_params_total = param_offsets(agent.cfg)[-1][1]
    dev, dtype = image.device, image.dtype

    img, st = image, states
    stop = torch.zeros((n,), dtype=torch.float32, device=dev)
    sels, pdfs, params, imgs = [], [], [], []
    with span("rollout"):
        for t in range(steps):
            with span("rollout.step"):
                if early_exit and _all_stopped(stop):
                    sels.append(torch.full((n,), -1, dtype=torch.int32,
                                           device=dev))
                    pdfs.append(torch.zeros((n, agent.cfg.n_filters),
                                            dtype=dtype, device=dev))
                    params.append(torch.zeros((n, n_params_total),
                                              dtype=dtype, device=dev))
                    continue
                out, new_states, _, _, _, info = agent(
                    img, noises[t], st, 1.0, train=False,
                    selected_filter_id=pipeline[t], render=render)
                stopped = stop > 0
                img = torch.where(stopped[:, None, None, None], img, out)
                st = torch.where(stopped[:, None], st, new_states)
                sels.append(torch.where(stopped, torch.full_like(
                    info["selected_filter"], -1), info["selected_filter"]))
                pdfs.append(info["pdf"])
                params.append(torch.cat(
                    [p.reshape(n, -1) for p in info["filter_params"]],
                    dim=-1))
                stop = torch.maximum(stop, st[:, STATE_STOPPED_DIM])
                if record_steps:
                    imgs.append(img)
    return RolloutResult(img, st, None, torch.stack(sels), torch.stack(pdfs),
                         torch.stack(imgs) if record_steps else None,
                         torch.stack(params))
