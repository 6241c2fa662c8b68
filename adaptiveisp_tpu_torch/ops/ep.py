"""Expert-parallel (ep) candidate rendering over a (data x expert) mesh
(port of ``adaptiveisp_tpu/ops/ep.py``).

The policy evaluates all K filter branches and blends them by a one-hot
action (``bank.render_blend``): a mixture of experts whose experts are all
dense.  Here the K branches are spread over the ``expert`` axis: expert
rank e renders only filters ``e K/E ... (e + 1) K/E - 1`` on its data rows,
weights them by its columns of the blend weights, and one all-reduce over
the ``expert`` subgroup completes the blend.  The gated ``denoise`` branch
takes its weight column as the per-image gate, so the K1 kernel runs only
on the rank that owns it, and only for images whose weight is not 0.

Forward only, as the JAX function is used; the result equals
``render_blend`` on the whole batch up to the order of the sum.
"""

from __future__ import annotations

from typing import Sequence

import torch

from adaptiveisp_tpu_torch import parallel
from adaptiveisp_tpu_torch.ops.bank import apply_one, filter_specs


def pad_stack_params(specs, params_list: Sequence) -> torch.Tensor:
    """[K, N, Pmax]: per-filter parameter rows zero-padded to the
    widest."""
    p_max = max(s.n_params for s in specs)
    return torch.stack([torch.nn.functional.pad(p, (0, p_max - s.n_params))
                        for s, p in zip(specs, params_list)])


def make_ep_blend_render(cfg, mesh):
    """The expert-parallel blend renderer on a (data x expert) mesh
    (``parallel.make_grid``).

    Returns ``fn(img [n,H,W,3], params_list, onehot [n,K]) -> [n,H,W,3]``
    for the rank's data rows (``parallel.shard_batch``): the K filters'
    [n, P_k] parameters and the blend weights (one-hot or soft) of those
    rows; every expert rank gets the same result.  Refuses
    ``cfg.masking`` and a filter count that does not divide over the
    experts, as JAX's does."""
    if cfg.masking:
        raise ValueError("ep render does not carry per-filter mask params; "
                         "disable cfg.masking (the default)")
    specs = filter_specs(cfg)
    n_expert = mesh.axis_size(parallel.EXPERT_AXIS)
    if len(specs) % n_expert:
        raise ValueError(
            f"{len(specs)} filters do not tile over {n_expert} experts")
    k_local = len(specs) // n_expert
    first = mesh.axis_rank(parallel.EXPERT_AXIS) * k_local

    @torch.no_grad()
    def fn(img, params_list, onehot):
        params_pad = pad_stack_params(specs, params_list)
        out = torch.zeros_like(img)
        for k in range(first, first + k_local):
            spec = specs[k]
            cand = apply_one(cfg, spec, img, params_pad[k, :, :spec.n_params],
                             gate=onehot[:, k] if spec.gated else None)
            out = out + cand * onehot[:, k, None, None, None]
        return parallel.all_reduce(mesh, out, axis=parallel.EXPERT_AXIS)

    return fn
