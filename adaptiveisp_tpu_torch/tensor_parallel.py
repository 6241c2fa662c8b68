"""Tensor parallelism of the detector over the ``model`` axis of a
(data x model) mesh (the port of ``tp_leaf_sharding``,
``tp_state_sharding`` and ``shard_detector_train_step`` of
``adaptiveisp_tpu/train/mesh.py``; ``train/mesh.py`` exports them).

JAX shards the output-channel dimension of every weight over ``model``
when it divides (flax kernels are HWIO, so it is the last dimension) and
GSPMD partitions the convolutions and inserts the collectives.  The port
runs one process per rank and does the partitioning itself, Megatron's
column-parallel way, layer by layer:

* each rank **holds** only its block of the output channels of every
  split layer: the conv's weight and bias, and for a conv + BatchNorm +
  activation block (``ConvBNAct``) the BatchNorm's scale, bias and
  running statistics as well; the optimizer's moments and the EMA follow
  their parameters, so they are sliced too;
* a split layer takes the whole input (every rank holds it) and computes
  its block of output channels; one all-gather over the model ranks
  concatenates the blocks, so the next layer again sees every channel;
* the adjoints: the gradient of the gathered output is whole on every
  rank (everything downstream is either replicated or split the same
  way), so the gather's backward keeps the rank's block; the gradient of
  the split layer's input is a partial sum over the rank's channels, so
  an identity placed before the layer sums it over the model ranks in its
  backward.  Replicated layers (widths that do not divide, e.g. YOLOv3's
  255-wide ``Detect`` convs, and every layer that is not a conv) compute
  whole gradients on every rank and need nothing.

The port's weights are OIHW and (out, in): the output channels are the
**first** dimension, so the rule that JAX applies to the last dimension
applies here to the first.  Checkpoints hold whole tensors
(:func:`gather_state`), equal to a single process's; loading slices them
(:func:`slice_state`).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist
import torch.nn as nn

from adaptiveisp_tpu_torch import parallel
from adaptiveisp_tpu_torch.parallel import MODEL_AXIS


def tp_leaf_sharding(mesh, leaf) -> tuple:
    """The channel rule by shape alone on the port's layout: a tensor
    whose first (output-channel) dimension divides over the model ranks
    is split along it, ``(MODEL_AXIS, None, ...)``; anything else
    (Detect's 255-wide convs, scalars) is replicated, ``()``.  JAX's
    ``PartitionSpec`` on the flax layout, with the dimensions permuted
    as ``convert.py`` permutes them."""
    n_model = mesh.axis_size(MODEL_AXIS)
    shape = tuple(getattr(leaf, "shape", ()))
    if shape and shape[0] % n_model == 0 and shape[0] >= n_model:
        return (MODEL_AXIS,) + (None,) * (len(shape) - 1)
    return ()


def _units(model: nn.Module, n_model: int):
    """The layers the port splits: ``(module, tensors)`` with ``module``
    the one whose output is gathered and ``tensors`` the ``state_dict``
    names (relative to ``model``) of its sliced parameters and buffers.
    A ``ConvBNAct`` with one group and an activation without parameters
    is one unit (conv, BatchNorm, activation on the rank's channels);
    any other conv with one group is a unit alone.  One model rank splits
    nothing."""
    from adaptiveisp_tpu_torch.detect.layers import ConvBNAct

    units, taken = [], set()
    if n_model == 1:
        return units
    for name, m in model.named_modules():
        if (isinstance(m, ConvBNAct) and m.conv.groups == 1
                and not any(True for _ in m.act.parameters())
                and m.conv.out_channels % n_model == 0):
            keys = [f"{name}.conv.weight"]
            if m.conv.bias is not None:
                keys.append(f"{name}.conv.bias")
            keys += [f"{name}.bn.{k}" for k in
                     ("weight", "bias", "running_mean", "running_var")]
            units.append((m, keys))
            taken.add(id(m.conv))
    for name, m in model.named_modules():
        if (isinstance(m, nn.Conv2d) and id(m) not in taken
                and m.groups == 1 and m.out_channels % n_model == 0):
            keys = [f"{name}.weight"]
            if m.bias is not None:
                keys.append(f"{name}.bias")
            units.append((m, keys))
    return units


def tp_state_sharding(mesh, model: nn.Module) -> Dict[str, tuple]:
    """The spec of every ``state_dict`` entry of ``model`` under tensor
    parallelism: :func:`tp_leaf_sharding`'s split for the tensors of the
    layers the port splits, ``()`` for the rest.  On YOLOv3 and the
    detector specs (conv blocks and Detect convs) it is the leaf rule on
    every tensor but the scalar step counters."""
    split = {k for _, keys in _units(model, mesh.axis_size(MODEL_AXIS))
             for k in keys}
    return {k: (tp_leaf_sharding(mesh, v) if k in split else ())
            for k, v in model.state_dict().items()}


def _block(mesh, n: int) -> slice:
    per = n // mesh.axis_size(MODEL_AXIS)
    r = mesh.axis_rank(MODEL_AXIS)
    return slice(r * per, (r + 1) * per)


class _ToModel(torch.autograd.Function):
    """Identity forward; the backward sums the input's partial gradients
    over the model ranks (each rank's split layer saw the whole input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherChannels(torch.autograd.Function):
    """The model ranks' channel blocks of an NCHW tensor concatenated
    (forward); the backward keeps the rank's block of the whole
    gradient."""

    @staticmethod
    def forward(ctx, y, mesh):
        n = mesh.axis_size(MODEL_AXIS)
        ctx.block = _block(mesh, y.shape[1] * n)
        return parallel.all_gather(mesh, y, axis=MODEL_AXIS, dim=1)

    @staticmethod
    def backward(ctx, g):
        return g[:, ctx.block].contiguous(), None


def slice_state(mesh, state: Dict[str, torch.Tensor],
                specs: Dict[str, tuple]) -> Dict[str, torch.Tensor]:
    """The rank's blocks of the split entries of a whole ``state``
    (names as in ``specs``); the others as they are."""
    out = {}
    for k, v in state.items():
        if specs.get(k):
            v = v[_block(mesh, v.shape[0])].clone()
        out[k] = v
    return out


def gather_state(mesh, state: Dict[str, torch.Tensor],
                 specs: Dict[str, tuple]) -> Dict[str, torch.Tensor]:
    """Whole tensors from every rank's blocks of the split entries (a
    collective over the model ranks: every rank calls it, in the same
    order)."""
    return {k: (parallel.all_gather(mesh, v, axis=MODEL_AXIS)
                if specs.get(k) else v) for k, v in state.items()}


def shard_model(mesh, model: nn.Module) -> Dict[str, tuple]:
    """Split ``model`` in place over the model ranks: each split layer's
    tensors become the rank's blocks (the same ``Parameter`` objects, so
    an optimizer built on them keeps them), and the layer gets the
    identity before it and the gather after it.  Returns
    :func:`tp_state_sharding`."""
    specs = tp_state_sharding(mesh, model)
    group = mesh.group(MODEL_AXIS)
    tensors = dict(model.named_parameters())
    tensors.update(model.named_buffers())
    with torch.no_grad():
        for k, spec in specs.items():
            if spec:
                t = tensors[k]
                t.data = t.data[_block(mesh, t.shape[0])].clone()
    for m, _ in _units(model, mesh.axis_size(MODEL_AXIS)):
        if isinstance(m, nn.Conv2d):
            m.out_channels = m.weight.shape[0]
        else:
            m.conv.out_channels = m.conv.weight.shape[0]
            m.bn.num_features = m.bn.weight.shape[0]
        m.register_forward_pre_hook(
            lambda mod, args: (_ToModel.apply(args[0], group),) + args[1:])
        m.register_forward_hook(
            lambda mod, args, out: _GatherChannels.apply(out, mesh))
    model._tp_specs = specs
    return specs


def _optimizer_names(optimizer, model):
    names = {id(p): n for n, p in model.named_parameters()}
    return [names[id(p)] for g in optimizer.param_groups
            for p in g["params"]]


def _map_optimizer_state(sd, optimizer, model, fn):
    """``sd`` (an ``optimizer.state_dict()``) with ``fn(tensor, name)``
    applied to every moment, ``name`` its parameter's."""
    names = {id(p): n for n, p in model.named_parameters()}
    order = [names[id(p)] for g in optimizer.param_groups
             for p in g["params"]]
    sd = dict(sd)
    sd["state"] = {i: {k: (fn(v, order[i])
                           if torch.is_tensor(v) and v.ndim else v)
                       for k, v in st.items()}
                   for i, st in sd["state"].items()}
    return sd


def gather_optimizer_state(mesh, optimizer, model, specs):
    """``optimizer.state_dict()`` with the moments of split parameters
    whole (a collective over the model ranks), as a checkpoint holds
    them."""
    return _map_optimizer_state(
        optimizer.state_dict(), optimizer, model,
        lambda v, n: (parallel.all_gather(mesh, v, axis=MODEL_AXIS)
                      if specs.get(n) else v))


def slice_optimizer_state(mesh, sd, optimizer, model, specs):
    """A checkpoint's whole optimizer state with the rank's blocks of the
    split parameters' moments, for ``optimizer.load_state_dict``."""
    return _map_optimizer_state(
        sd, optimizer, model,
        lambda v, n: (v[_block(mesh, v.shape[0])].clone()
                      if specs.get(n) else v))


def shard_detector_train_step(train_step, mesh, state):
    """The detector train step over a (data x model) mesh (JAX's
    ``shard_detector_train_step``): splits ``state`` (a
    ``DetTrainState``: model, optimizer moments and EMA) by
    :func:`tp_state_sharding` in place and returns ``(step, state)``.
    The step itself is the data-parallel one (``make_detector_train_step
    (mesh=mesh)``): batch statistics, loss divisors and gradients reduce
    over the data ranks; the model's split layers gather their channels
    over the model ranks."""
    specs = shard_model(mesh, state.model)
    for k, v in list(state.ema.params.items()):
        if specs.get(k):
            state.ema.params[k] = v[_block(mesh, v.shape[0])].clone()
    opt = state.optimizer
    for p, st in opt.state.items():
        for key, v in list(st.items()):
            if torch.is_tensor(v) and v.shape[:1] != p.shape[:1]:
                st[key] = v[_block(mesh, v.shape[0])].clone()
    return train_step, state


def state_bytes(state) -> Dict[str, int]:
    """Bytes of the model's parameters and of the optimizer's moments on
    this rank."""
    params = sum(p.numel() * p.element_size()
                 for p in state.model.parameters())
    moments = sum(v.numel() * v.element_size()
                  for st in state.optimizer.state.values()
                  for v in st.values() if torch.is_tensor(v))
    return {"params": params, "optimizer": moments}
