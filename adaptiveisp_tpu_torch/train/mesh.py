"""The meshes under JAX's names (port of ``adaptiveisp_tpu/train/
mesh.py``): the mesh values, sharding, replication and the barrier come
from :mod:`adaptiveisp_tpu_torch.parallel`, which the networks, losses,
renders and validator below the trainers use, and the tensor-parallel
rule and step from :mod:`adaptiveisp_tpu_torch.tensor_parallel`; this
module adds the 2-D makers and the actor-critic step over the data mesh
(:func:`shard_train_step`).

Run a function on N ranks with :func:`launch` (``device="cpu"``: N gloo
ranks; on cards N NCCL ranks), or start the ranks with ``torchrun``, and
call a maker on each: :func:`make_mesh` (data), :func:`make_mesh_2d`
(data x spatial: ``ops.bank.make_sharded_render``, the HR validation),
:func:`make_mesh_dp_tp` (data x model: the detector trainer),
:func:`make_mesh_dp_ep` (data x expert: ``ops.ep``) or
:func:`make_mesh_dp_pp` (data x pipe: ``ops.pp``).
"""

from __future__ import annotations

from typing import Optional

import torch

from adaptiveisp_tpu_torch.parallel import (  # noqa: F401
    DATA_AXIS,
    EXPERT_AXIS,
    MODEL_AXIS,
    PIPE_AXIS,
    SPATIAL_AXIS,
    Mesh,
    Rows,
    all_gather,
    all_reduce,
    cli_mesh,
    data_parallel,
    data_sharding,
    gather_rows,
    launch,
    make_grid,
    make_mesh,
    replicate,
    resolve_ranks,
    shard_batch,
    shard_image,
    spatial_image_sharding,
    sync_global_devices,
    sync_gradients,
)
from adaptiveisp_tpu_torch.tensor_parallel import (  # noqa: F401
    shard_detector_train_step,
    tp_leaf_sharding,
    tp_state_sharding,
)


def make_mesh_2d(n_data: int, n_spatial: int, device=None,
                 backend: Optional[str] = None) -> Mesh:
    """(data x spatial) mesh: batch over ``data``, image rows over
    ``spatial`` (one big frame's rows over several cards)."""
    return make_grid(n_data, n_spatial, SPATIAL_AXIS, device, backend)


def make_mesh_dp_tp(n_data: int, n_model: int, device=None,
                    backend: Optional[str] = None) -> Mesh:
    """(data x model) mesh for tensor-parallel detector training: batch
    over ``data``, conv output channels over ``model``."""
    return make_grid(n_data, n_model, MODEL_AXIS, device, backend)


def make_mesh_dp_ep(n_data: int, n_expert: int, device=None,
                    backend: Optional[str] = None) -> Mesh:
    """(data x expert) mesh: batch over ``data``, the K filter branches of
    the blend over ``expert``."""
    return make_grid(n_data, n_expert, EXPERT_AXIS, device, backend)


def make_mesh_dp_pp(n_data: int, n_pipe: int, device=None,
                    backend: Optional[str] = None) -> Mesh:
    """(data x pipe) mesh: microbatch rows over ``data``, the stages of a
    scripted chain over ``pipe``."""
    return make_grid(n_data, n_pipe, PIPE_AXIS, device, backend)

# the RL step's scalar metrics, averaged over the ranks in one all-reduce
_MEAN_METRICS = ("agent_loss", "value_loss", "detect_input_loss",
                 "detect_retouch_loss", "reward", "penalty", "q_value",
                 "retouch_mean")


def shard_train_step(train_step, mesh: Mesh):
    """The actor-critic step over the data mesh (JAX's
    ``shard_train_step``).

    Each rank passes its rows of the batch and one generator seeded as the
    others'.  The step runs in :func:`data_parallel` (global BatchNorm,
    dropout at the global shape); both optimizers average their gradients
    over the ranks before the clip.  The output holds the rank's rows of
    ``retouch``; ``new_states``, ``selected_filter`` and
    ``retouch_loss_per_image`` gathered over the ranks; the scalar metrics
    as global means and ``retouch_finite`` over every rank's rows."""
    from adaptiveisp_tpu_torch.train.step import StepOutput

    def step(state, batch, generator, progress, mark=None):
        sync_gradients(state.agent_opt, mesh)
        sync_gradients(state.value_opt, mesh)
        with data_parallel(mesh):
            out = train_step(state, batch, generator, progress, mark)
        m = dict(out.metrics)
        packed = torch.cat([
            torch.stack([m[k].to(torch.float32) for k in _MEAN_METRICS]),
            m["loss_components"].to(torch.float32),
            (~m["retouch_finite"]).to(torch.float32)[None]])
        packed = all_reduce(mesh, packed)
        k = len(_MEAN_METRICS)
        for i, name in enumerate(_MEAN_METRICS):
            m[name] = packed[i] / mesh.data_size
        m["loss_components"] = packed[k:k + 3] / mesh.data_size
        m["retouch_finite"] = packed[k + 3] == 0
        m["selected_filter"] = all_gather(mesh, m["selected_filter"])
        m["retouch_loss_per_image"] = all_gather(
            mesh, m["retouch_loss_per_image"])
        return StepOutput(out.state, out.retouch,
                          all_gather(mesh, out.new_states), m)

    return step
