"""Data parallelism under JAX's names (port of the data-parallel half of
``adaptiveisp_tpu/train/mesh.py``): the mesh, sharding, replication and
the barrier come from :mod:`adaptiveisp_tpu_torch.parallel`, which the
networks, losses and validator below the trainers use; this module adds
the actor-critic step over the data mesh (:func:`shard_train_step`).

Run a function on N ranks with :func:`launch` (``device="cpu"``: N gloo
ranks; on cards N NCCL ranks), or start the ranks with ``torchrun`` and
call :func:`make_mesh` on each.  The 2-D makers and ``tp_*`` come with
the next parallelism slice.
"""

from __future__ import annotations

import torch

from adaptiveisp_tpu_torch.parallel import (  # noqa: F401
    DATA_AXIS,
    Mesh,
    all_gather,
    all_reduce,
    cli_mesh,
    data_parallel,
    data_sharding,
    launch,
    make_mesh,
    replicate,
    resolve_ranks,
    shard_batch,
    sync_global_devices,
    sync_gradients,
)

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
            m[name] = packed[i] / mesh.size
        m["loss_components"] = packed[k:k + 3] / mesh.size
        m["retouch_finite"] = packed[k + 3] == 0
        m["selected_filter"] = all_gather(mesh, m["selected_filter"])
        m["retouch_loss_per_image"] = all_gather(
            mesh, m["retouch_loss_per_image"])
        return StepOutput(out.state, out.retouch,
                          all_gather(mesh, out.new_states), m)

    return step
