"""Model export (port of ``adaptiveisp_tpu/detect/export.py``).

The JAX package serialises the jitted forward as StableHLO and the
variables as a pickle.  The port's counterparts: a ``torch.export``
program saved as ``.pt2`` (the forward's graph with its weights, loadable
by ``torch.export.load`` without the module's Python code), and the
``state_dict`` through ``torch.save``.

The gated NLM is the registered operator
``torch.ops.adaptiveisp_tpu_torch.nlm_gray`` (``ops/cuda/nlm.py``): one
opaque node per call in the program.  Run on the card it launches K1; moved
to the CPU (``torch.export.passes.move_to_device_pass``) it runs the plain
version, the counterpart of JAX's multi-platform lowering.  So the port must
be imported before a program holding it is loaded: :func:`load_program`
does that.
"""

from __future__ import annotations

import os
from typing import Mapping, Sequence

import torch
from torch import nn


class _Program(nn.Module):
    """A function of tensors over ``module``'s parameters and buffers, as
    the module ``torch.export`` takes."""

    def __init__(self, module: nn.Module, fn):
        super().__init__()
        self.module = module
        self.fn = fn

    def forward(self, *args):
        return self.fn(self.module, *args)


def _makedirs_for(path: str):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)


def export_program(fn_or_module, example_args: Sequence[torch.Tensor],
                   path: str) -> str:
    """``torch.export`` of ``fn_or_module`` at the example arguments' shapes
    and devices, saved to ``path`` (``.pt2``).  A module is exported as it
    stands (set eval mode first where that matters); a plain function
    holds no weights of its own."""
    module = fn_or_module
    if not isinstance(module, nn.Module):
        module = _Program(nn.Module(), lambda _m, *a: fn_or_module(*a))
    with torch.no_grad():   # inference programs: no grad-mode nodes
        program = torch.export.export(module, tuple(example_args))
    _makedirs_for(path)
    torch.export.save(program, path)
    return path


def load_program(path: str) -> torch.export.ExportedProgram:
    """The program saved at ``path``; registers the port's operators first
    (the gated NLM's nodes name them)."""
    import adaptiveisp_tpu_torch.ops.cuda.nlm  # noqa: F401

    return torch.export.load(path)


def export_detector(model: nn.Module, path: str, imgsz: int = 512,
                    batch: int = 1, spec=None) -> str:
    """Detector forward + decode as one program: images [batch, imgsz,
    imgsz, 3] on the model's device -> decoded [batch, candidates, no]."""
    from adaptiveisp_tpu_torch.detect.model import decode_predictions

    model = model.eval()
    dev = next(model.parameters()).device
    x = torch.zeros((batch, imgsz, imgsz, 3), dtype=torch.float32,
                    device=dev)
    return export_program(
        _Program(model, lambda m, im: decode_predictions(m(im), spec)),
        (x,), path)


def export_adaptive_isp(cfg, agent: nn.Module, path: str, imgsz: int = 512,
                        steps: int = 5, batch: int = 1) -> str:
    """The adaptive ``steps``-step ISP rollout as one program: images
    [batch, imgsz, imgsz, 3], noises [steps, batch, z_dim], states [batch,
    num_state_dim] -> (image, states, selected).  The rollout runs without
    its early exit, a host read a program cannot hold; JAX's
    ``jit_rollout`` has none either, and these three outputs do not depend
    on it."""
    from adaptiveisp_tpu_torch.eval.rollout import no_pipeline, rollout

    agent = agent.eval()
    dev = next(agent.parameters()).device

    def fn(m, images, noises, states):
        res = rollout(m, images, noises, states, no_pipeline(steps),
                      early_exit=False)
        return res.image, res.states, res.selected

    zeros = lambda *s: torch.zeros(s, dtype=torch.float32,  # noqa: E731
                                   device=dev)
    return export_program(
        _Program(agent, fn),
        (zeros(batch, imgsz, imgsz, 3), zeros(steps, batch, cfg.z_dim),
         zeros(batch, cfg.num_state_dim)), path)


def save_variables(module_or_state_dict, path: str) -> str:
    """The ``state_dict`` (on the CPU) through ``torch.save``: the keys that
    the JAX package's ``detect/convert.py`` converters read."""
    sd = (module_or_state_dict.state_dict()
          if isinstance(module_or_state_dict, nn.Module)
          else module_or_state_dict)
    _makedirs_for(path)
    torch.save({k: v.detach().cpu() for k, v in sd.items()}, path)
    return path


def load_variables(path: str) -> Mapping[str, torch.Tensor]:
    return torch.load(path, map_location="cpu", weights_only=True)
