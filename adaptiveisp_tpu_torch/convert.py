"""Carry weights across from the JAX package's flax trees to the port.

``agent_from_flax``, ``value_from_flax`` and ``yolo_from_flax`` take flax
``params`` and ``batch_stats`` trees (nested dicts of numpy arrays) and
return a ``state_dict`` for the port's ``policy.agent.Agent``,
``policy.value.Value`` and ``detect.model.DetectionModel``.  The port's keys
are the original AdaptiveISP / ultralytics names, so
``adaptiveisp_tpu/detect/convert.py`` (``convert_agent_state_dict``,
``convert_value_state_dict``, ``convert_yolo_state_dict``) inverts these
exactly (the Segment head's Proto tower included).
``classifier_from_flax`` does the same for ``classify.ClassificationModel``;
the JAX package has no converter for its classifier.

Layout transforms (the inverse of that module's):
  * conv kernel HWIO [kh, kw, I, O] -> [O, I, kh, kw]
  * dense kernel [I, O] -> linear weight [O, I]
  * BatchNorm (scale, bias) + (mean, var) -> weight, bias, running_mean,
    running_var (+ num_batches_tracked = 0)
  * a Linear eating trunk features: flax flattens the [4, 4, C] map in
    (h, w, c) order, torch in (c, h, w) order, so its input columns are
    permuted.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

from adaptiveisp_tpu_torch.detect.spec import flatten_layers
from adaptiveisp_tpu_torch.ops.bank import filter_specs
from adaptiveisp_tpu_torch.policy.nets import MIN_FEATURE_MAP_SIZE


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _conv(kernel) -> torch.Tensor:
    return _t(np.transpose(np.asarray(kernel), (3, 2, 0, 1)))


def _linear(kernel) -> torch.Tensor:
    return _t(np.asarray(kernel).T)


def _bn(sd, prefix, params, stats):
    sd[f"{prefix}.weight"] = _t(params["scale"])
    sd[f"{prefix}.bias"] = _t(params["bias"])
    sd[f"{prefix}.running_mean"] = _t(stats["mean"])
    sd[f"{prefix}.running_var"] = _t(stats["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def trunk_linear(kernel, c: int, h: int = MIN_FEATURE_MAP_SIZE,
                 w: int = MIN_FEATURE_MAP_SIZE) -> torch.Tensor:
    """flax Dense kernel [(h, w, c) flat, O] -> torch weight [O, (c, h, w)
    flat]."""
    kernel = np.asarray(kernel)
    if kernel.shape[0] != c * h * w:
        raise ValueError(f"dense in-features {kernel.shape[0]} != trunk "
                         f"{c}x{h}x{w}")
    perm = np.arange(c * h * w).reshape(c, h, w).transpose(1, 2, 0).reshape(-1)
    out = np.empty((kernel.shape[1], kernel.shape[0]), np.float32)
    out[:, perm] = kernel.T
    return _t(out)


def _trunk(sd, prefix, params, stats):
    k = 0
    while f"Conv_{k}" in params:
        sd[f"{prefix}.layers.{3 * k}.weight"] = _conv(params[f"Conv_{k}"]
                                                      ["kernel"])
        sd[f"{prefix}.layers.{3 * k}.bias"] = _t(params[f"Conv_{k}"]["bias"])
        _bn(sd, f"{prefix}.layers.{3 * k + 1}", params[f"BatchNorm_{k}"],
            stats[f"BatchNorm_{k}"])
        k += 1


def agent_from_flax(params, batch_stats, cfg) -> Dict[str, torch.Tensor]:
    """flax Agent variables -> state_dict of the port's ``Agent``."""
    sd: Dict[str, torch.Tensor] = {}
    for trunk in ("feature_extractor", "action_selection"):
        _trunk(sd, trunk, params[trunk], batch_stats[trunk])
    c = cfg.feature_extractor_dims // MIN_FEATURE_MAP_SIZE ** 2
    sel = params["selector_head"]
    sd["fc1.weight"] = trunk_linear(sel["Dense_0"]["kernel"], c)
    sd["fc1.bias"] = _t(sel["Dense_0"]["bias"])
    sd["fc2.weight"] = _linear(sel["Dense_1"]["kernel"])
    sd["fc2.bias"] = _t(sel["Dense_1"]["bias"])
    for spec in filter_specs(cfg):
        head, sn = params[f"head_{spec.name}"], spec.short_name
        sd[f"{sn}.fc1.weight"] = trunk_linear(head["fc1"]["kernel"], c)
        sd[f"{sn}.fc1.bias"] = _t(head["fc1"]["bias"])
        for lin in ("fc_filter", "fc_mask"):
            sd[f"{sn}.{lin}.weight"] = _linear(head[lin]["kernel"])
            sd[f"{sn}.{lin}.bias"] = _t(head[lin]["bias"])
    return sd


def value_from_flax(params, batch_stats, cfg) -> Dict[str, torch.Tensor]:
    """flax Value variables -> state_dict of the port's ``Value``."""
    sd: Dict[str, torch.Tensor] = {}
    _trunk(sd, "feature_extractor", params["feature_extractor"],
           batch_stats["feature_extractor"])
    head = params["head"]
    sd["fc1.weight"] = trunk_linear(
        head["Dense_0"]["kernel"],
        cfg.feature_extractor_dims // MIN_FEATURE_MAP_SIZE ** 2)
    sd["fc1.bias"] = _t(head["Dense_0"]["bias"])
    sd["fc2.weight"] = _linear(head["Dense_1"]["kernel"])
    sd["fc2.bias"] = _t(head["Dense_1"]["bias"])
    return sd


_YOLO_CHILD = (
    (re.compile(r"m(\d+)"), "m.{}"),          # Detect levels, C3 blocks
    (re.compile(r"tr(\d+)"), "tr.{}"),        # transformer layers
    (re.compile(r"conv(\d+)"), "conv.{}"),    # GhostBottleneck's convs
    (re.compile(r"short(\d+)"), "shortcut.{}"),
)


def _yolo_child(name: str) -> str:
    for pat, fmt in _YOLO_CHILD:
        m = pat.fullmatch(name)
        if m:
            return fmt.format(m.group(1))
    return "ma.out_proj" if name == "out_proj" else name


def yolo_from_flax(params, batch_stats, spec) -> Dict[str, torch.Tensor]:
    """flax DetectionModel variables -> state_dict of the port's
    ``DetectionModel`` in ultralytics naming: layer ``l{i}`` -> ``model.{i}``,
    repeat ``l{i}_{r}`` -> ``model.{i}.{r}``, ``m{j}`` (Detect levels, C3
    blocks) -> ``m.{j}``, ``tr{r}`` -> ``tr.{r}``, GhostBottleneck's
    ``conv{j}`` / ``short{j}`` -> ``conv.{j}`` / ``shortcut.{j}``, the
    attention's ``in_q``/``in_k``/``in_v`` -> ``ma.in_proj_weight`` /
    ``ma.in_proj_bias`` and ``out_proj`` -> ``ma.out_proj``; activation
    parameters (``act``: AconC's p1/p2/beta [1,1,1,C] -> [1,C,1,1])."""
    n_layers = len(flatten_layers(spec))
    sd: Dict[str, torch.Tensor] = {}

    def emit(prefix, ptree, stree):
        if "in_q" in ptree:  # torch MHA's joint in-projection
            sd[f"{prefix}.ma.in_proj_weight"] = torch.cat(
                [_linear(ptree[k]["kernel"]) for k in ("in_q", "in_k",
                                                       "in_v")])
            sd[f"{prefix}.ma.in_proj_bias"] = torch.cat(
                [_t(ptree[k]["bias"]) for k in ("in_q", "in_k", "in_v")])
        for k, v in ptree.items():
            if k in ("in_q", "in_k", "in_v"):
                continue
            name = f"{prefix}.{_yolo_child(k)}"
            if not isinstance(v, dict):  # an activation's own parameter
                sd[name] = _t(np.transpose(np.asarray(v), (0, 3, 1, 2)))
            elif "scale" in v:  # BatchNorm
                _bn(sd, name, v, stree[k])
            elif "kernel" in v:  # conv or dense
                kern = np.asarray(v["kernel"])
                sd[f"{name}.weight"] = (_conv(kern) if kern.ndim == 4
                                        else _linear(kern))
                if "bias" in v:
                    sd[f"{name}.bias"] = _t(v["bias"])
            else:  # nested block
                emit(name, v, stree.get(k, {}))

    for lname, ptree in params.items():
        m = re.fullmatch(r"l(\d+)(?:_(\d+))?", lname)
        if m is None or int(m.group(1)) >= n_layers:
            raise ValueError(f"flax layer {lname!r} is not in the spec's "
                             f"{n_layers} rows")
        prefix = f"model.{m.group(1)}" + (
            f".{m.group(2)}" if m.group(2) is not None else "")
        emit(prefix, ptree, batch_stats.get(lname, {}))
    return sd


def classifier_from_flax(params, batch_stats, spec=None,
                         cutoff=None) -> Dict[str, torch.Tensor]:
    """flax ClassificationModel variables -> state_dict of the port's
    ``classify.ClassificationModel``: the trunk ``backbone/trunk/l{i}`` ->
    ``model.{i}.*`` (as :func:`yolo_from_flax`), ``head_conv`` ->
    ``model.{k}.conv.*`` and ``head_linear`` -> ``model.{k}.linear.*``, k the
    number of backbone rows kept (``spec`` defaults to YOLOv3-tiny's, as
    the JAX model's)."""
    from adaptiveisp_tpu_torch.classify import trunk_spec

    tspec = trunk_spec(spec, cutoff)
    k = len(tspec["backbone"])
    # the JAX trunk ends in an Identity row: count it as a layer
    sd = yolo_from_flax(params["backbone"]["trunk"],
                        batch_stats["backbone"]["trunk"],
                        dict(tspec, head=[[-1, 1, "Identity", []]]))
    head = params["head_conv"]
    sd[f"model.{k}.conv.conv.weight"] = _conv(head["conv"]["kernel"])
    _bn(sd, f"model.{k}.conv.bn", head["bn"],
        batch_stats["head_conv"]["bn"])
    sd[f"model.{k}.linear.weight"] = _linear(
        params["head_linear"]["kernel"])
    sd[f"model.{k}.linear.bias"] = _t(params["head_linear"]["bias"])
    return sd
