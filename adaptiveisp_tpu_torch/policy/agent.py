"""The RL policy network: picks an ISP filter and regresses its parameters
(port of ``adaptiveisp_tpu/policy/agent.py``).

  * a trunk extracts features from the 64x64-pooled image enriched with
    state channels; per-filter heads regress every filter's parameters;
  * a second trunk + MLP gives the action pdf, mixed with exploration;
    actions are sampled by inverse CDF from external uniform noise;
  * the chosen filter renders the image, as a one-hot blend of all
    candidates (``render="blend"``) or as the one filter the whole batch
    shares (``render="switch"``); a ``high_res`` frame, when given, is
    rendered the same way with the same parameters (the policy reads only
    the proxy ``x``).

The state-dict keys are the original AdaptiveISP names:
``feature_extractor.layers.*``, ``action_selection.layers.*``, ``fc1``/
``fc2`` (selector) and per-filter heads by short name (``NLM.fc_filter``).
A fresh agent starts from flax's initial distributions
(``nn_init.flax_init_``), as the JAX package's does.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from adaptiveisp_tpu_torch.nn_init import flax_init_
from adaptiveisp_tpu_torch.obs.profile import count, span
from adaptiveisp_tpu_torch.ops import bank
from adaptiveisp_tpu_torch.ops.math import adaptive_avg_pool, clip
from adaptiveisp_tpu_torch.policy.nets import (
    FeatureExtractor,
    FilterHead,
    mlp_head,
)
from adaptiveisp_tpu_torch.policy.states import (
    STATE_STEP_DIM,
    enrich_image_input,
    pdf_sample,
)


class Agent(nn.Module):
    """cfg is the :class:`adaptiveisp_tpu_torch.config.Config`."""

    def __init__(self, cfg, feature_size: int = 64):
        super().__init__()
        self.cfg = cfg
        self.feature_size = feature_size
        in_ch = 3 + (cfg.num_state_dim if cfg.img_include_states else 0)
        dropout = 1.0 - cfg.dropout_keep_prob

        def trunk():
            return FeatureExtractor(in_ch, cfg.base_channels,
                                    cfg.feature_extractor_dims, dropout,
                                    input_size=feature_size)

        self.feature_extractor = trunk()
        self.action_selection = trunk()
        self.fc1 = nn.Linear(cfg.feature_extractor_dims, cfg.fc1_size)
        self.fc2 = nn.Linear(cfg.fc1_size, cfg.n_filters)
        self.specs = bank.filter_specs(cfg)
        for s in self.specs:
            self.add_module(s.short_name, FilterHead(
                cfg.feature_extractor_dims, cfg.fc1_size, s.n_params))
        if cfg.filter_runtime_penalty:   # on the device, made once
            self.register_buffer("runtime", torch.tensor(
                cfg.filters_runtime, dtype=torch.float64), persistent=False)
        flax_init_(self)

    def forward(self, x, z, states, progress, train: bool = False,
                high_res=None, selected_filter_id=None,
                render: str = "blend",
                generator: torch.Generator | None = None,
                high_res_rows=None):
        """Run one policy step.

        x [N, H, W, 3]; z [N, z_dim]; states [N, num_state_dim]; progress a
        scalar in [0, 1].  ``train`` picks sampled (True) or argmax (False)
        actions and must agree with the module's train()/eval() mode, which
        drives BatchNorm and dropout (``generator`` draws the dropout masks
        of both trunks, flax's ``dropout`` rng; needed in train mode when
        ``cfg.dropout_keep_prob < 1``).  ``selected_filter_id``: None, an
        int or a scalar int tensor forcing the action for the whole batch; a
        negative value means the agent's own choice.  ``high_res``: an
        optional [N, H', W', 3] frame of any size, rendered with the
        proxy's parameters, selection and masks; ``high_res_rows`` (a
        ``parallel.Rows``) when it is a spatial rank's block of rows: the
        windowed filters then exchange halos with the neighbouring ranks.

        Returns (out, new_states, surrogate, penalty, high_res_out, info);
        high_res_out is None without ``high_res``.
        """
        if train != self.training:
            raise ValueError(f"train={train} but the module is in "
                             f"{'train' if self.training else 'eval'} mode")
        cfg = self.cfg
        n_filters = cfg.n_filters
        selection_noise = z[:, 0:1]

        with span("agent.nets"):
            enriched = enrich_image_input(
                cfg, adaptive_avg_pool(x, self.feature_size), states)

            # ---- per-filter parameter regression ----
            filter_features = self.feature_extractor(enriched, generator)
            raw_params, mask_params, squashed = [], [], []
            for spec in self.specs:
                fp, mp = getattr(self, spec.short_name)(filter_features)
                raw_params.append(fp)
                mask_params.append(mp)
                squashed.append(spec.squash(cfg, fp))

            # ---- action selection ----
            logits = mlp_head(self.action_selection(enriched, generator),
                              self.fc1, self.fc2)
            pdf = torch.softmax(logits, dim=-1) + 1e-37
            pdf = pdf * (1 - cfg.exploration) + cfg.exploration / n_filters
            pdf = pdf / (pdf.sum(dim=1, keepdim=True) + 1e-30)
            entropy = torch.sum(-pdf * torch.log(pdf), dim=1, keepdim=True)

            random_filter_id = pdf_sample(pdf, selection_noise)
            max_filter_id = torch.argmax(pdf, dim=1).to(torch.int32)
            sel = random_filter_id if train else max_filter_id
            if selected_filter_id is not None:
                if not isinstance(selected_filter_id, torch.Tensor):
                    count("host_read.upload.agent")
                forced = torch.as_tensor(selected_filter_id, dtype=torch.int32,
                                         device=sel.device).expand_as(sel)
                sel = torch.where(forced >= 0, forced, sel)

            onehot = F.one_hot(sel.long(), n_filters).to(pdf.dtype)
        surrogate = torch.sum(onehot * torch.log(pdf + 1e-10), dim=1,
                              keepdim=True)

        # ---- render ----
        mask_list = mask_params if cfg.masking else None
        if render == "switch":
            def draw(img, rows=None):
                return bank.render_switch(cfg, img, squashed, sel[0],
                                          mask_list, rows=rows)
        elif render == "blend":
            def draw(img, rows=None):
                return bank.render_blend(cfg, img, squashed, onehot,
                                         mask_list, rows=rows)
        else:
            raise ValueError(f"unknown render mode {render!r}")
        with span("agent.render"):
            out = draw(x)
        high_res_out = None
        if high_res is not None:
            with span("agent.render"):
                high_res_out = draw(high_res, high_res_rows)

        # ---- new states ----
        step = states[:, STATE_STEP_DIM:STATE_STEP_DIM + 1]
        is_last_step = (torch.abs(step + 1 - cfg.test_steps)
                        < 1e-4).to(torch.float32)
        submitted = is_last_step
        filter_usage = states[:, STATE_STEP_DIM + 1:]
        usage_penalty = torch.sum(filter_usage * onehot, dim=1, keepdim=True)
        new_filter_usage = torch.maximum(filter_usage, onehot)
        new_states = torch.cat(
            [submitted, submitted, step + 1, new_filter_usage], dim=1)

        # ---- penalties ----
        early_stop_penalty = ((1 - is_last_step) * submitted
                              * cfg.early_stop_penalty)
        entropy_penalty = ((1.0 - progress) * cfg.exploration_penalty
                           * (-entropy + cfg.log_n_filters))
        runtime_penalty = 0.0
        if cfg.filter_runtime_penalty:
            runtime_penalty = (cfg.filter_runtime_penalty_lambda
                               * torch.sum(onehot * self.runtime.to(
                                   pdf.dtype), dim=1, keepdim=True))

        if cfg.clamp:
            out = clip(out, 0.0, 5.0)

        overflow = torch.mean(clip(out - 1, 0.0) ** 2,
                              dim=(1, 2, 3))[:, None]
        penalty = (overflow + entropy_penalty
                   + usage_penalty * cfg.filter_usage_penalty
                   + early_stop_penalty + runtime_penalty)

        info: Dict[str, Any] = {
            "pdf": pdf,
            "entropy": entropy,
            "selected_filter": sel,
            "random_filter_id": random_filter_id,
            "max_filter_id": max_filter_id,
            "filter_params": tuple(squashed),
            "raw_filter_params": tuple(raw_params),
            "mask_params": tuple(mask_params),
            "usage_penalty": usage_penalty,
            "entropy_penalty": entropy_penalty,
            "runtime_penalty": runtime_penalty,
        }
        return out, new_states, surrogate, penalty, high_res_out, info
