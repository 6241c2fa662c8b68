"""Parallelism over ranks: the mesh value, the process group, the
collectives, the step's data group and a frame's rows over the spatial
axis (the port of ``adaptiveisp_tpu/train/mesh.py`` but for the
tensor-parallel rule, which ``tensor_parallel.py`` holds; ``train/mesh.py``
gives both JAX's names and adds the RL step's ``shard_train_step``).

The JAX package has one controller over a ``Mesh``: the batch is sharded
over the ``data`` axis in contiguous row blocks, parameters are
replicated, and XLA inserts every reduction, so one sharded step equals
the single-device step on the global batch.  The port runs one process
per rank over ``torch.distributed`` and makes the same reductions by hand:

* every rank runs the same seeded host streams (replay sampling, feeder
  order, noise, dropout masks drawn at the global shape) and keeps its own
  rows (:func:`data_sharding`, :func:`shard_batch`);
* train-mode BatchNorm takes the global mean and biased variance through
  one differentiable all-reduce a layer, as flax's ``pmean`` does
  (:func:`global_moments`, used by ``policy/nets.py``), and dropout draws
  its mask at the global shape and keeps the rank's rows
  (:func:`global_rows_mask`), while a :func:`data_parallel` context is
  active: the counterpart of flax's ``axis_name`` bound inside the
  sharded step;
* each optimizer all-reduces its network's gradients as one flat buffer
  before it clips and updates (:func:`sync_gradients`): one mechanism for
  the RL step and the detector, segmentation and classifier trainers.

``DistributedDataParallel`` is not used: the RL step runs the critic twice
before its one backward pass, the detector loss needs batch-global
divisors, and BatchNorm's statistics are made global by the layer itself;
a flat all-reduce per optimizer keeps one explicit collective per network
and step in a fixed order on every rank.

The mesh is a small value (:class:`Mesh`: rank, size, device, backend,
and per axis its name, size, the rank's coordinate and a process
subgroup), not ``torch.distributed.device_mesh.DeviceMesh``: a DeviceMesh
binds rank r to card r, so it cannot hold the two gloo ranks that share
one card in ``chip_smoke.py``.  A 1-D mesh (:func:`make_mesh`) has one
``data`` axis over the default group.  A 2-D mesh (:func:`make_grid`,
JAX's ``make_mesh_2d`` and ``make_mesh_dp_*`` in ``train/mesh.py``) puts
rank r at ``(r // n_axis, r % n_axis)``, as ``np.array(devs).reshape(
n_data, n_axis)`` places JAX's devices, with one subgroup per axis.
Every data-parallel collective here runs over the ``data`` subgroup, so
the second axis (spatial rows, experts, pipeline stages, model channels)
is invisible to the data-parallel code.  A frame's rows split over the
``spatial`` axis in blocks of ``ceil(H / n)`` (:class:`Rows`), and a
windowed stage reads its neighbours' rows through :func:`with_halo`.

Backends: NCCL on cards, gloo on the CPU.  NCCL refuses two ranks on one
card, so a caller that wants that passes ``backend="gloo"`` with CUDA
tensors itself; the library never picks gloo for a CUDA device.  A node
that is to run more ranks than it has visible cards raises.

This module imports only torch and numpy: the networks, losses and
validator below the trainers use it.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import datetime
import importlib
import os
import socket
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"
MODEL_AXIS = "model"
EXPERT_AXIS = "expert"
PIPE_AXIS = "pipe"

# the data mesh of the running step (policy/nets.py reads it)
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("data_mesh",
                                                         default=None)

# a collective waits this long for the other ranks: rank 0 validates and
# writes checkpoints alone while the others wait at the next one
GROUP_TIMEOUT = datetime.timedelta(minutes=60)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a mesh: its rank, the number of ranks, its
    device, the backend of the default group, and per axis its name, its
    size, the rank's coordinate and its process subgroup (None: the
    default group)."""

    rank: int
    size: int
    device: torch.device
    backend: str = "gloo"
    axis_names: tuple = (DATA_AXIS,)
    shape: tuple = ()
    coords: tuple = ()
    groups: tuple = (None,)

    def __post_init__(self):
        if not self.shape:   # a 1-D data mesh over the default group
            object.__setattr__(self, "shape", (self.size,))
            object.__setattr__(self, "coords", (self.rank,))

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def _axis(self, name: str) -> int:
        if name not in self.axis_names:
            raise ValueError(f"the mesh has axes {self.axis_names}, "
                             f"not {name!r}")
        return self.axis_names.index(name)

    def axis_size(self, name: str) -> int:
        return self.shape[self._axis(name)]

    def axis_rank(self, name: str) -> int:
        return self.coords[self._axis(name)]

    def group(self, name: str):
        return self.groups[self._axis(name)]

    def axis_ranks(self, name: str) -> list:
        """The global ranks of this rank's subgroup along ``name``, in
        coordinate order."""
        i = self._axis(name)
        stride = int(np.prod(self.shape[i + 1:], dtype=np.int64))
        base = self.rank - self.coords[i] * stride
        return [base + c * stride for c in range(self.shape[i])]

    @property
    def data_size(self) -> int:
        return self.axis_size(DATA_AXIS)

    @property
    def data_rank(self) -> int:
        return self.axis_rank(DATA_AXIS)


def _default_backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def node_ranks(world: int) -> int:
    """The ranks that run on this node: ``LOCAL_WORLD_SIZE`` (torchrun and
    :func:`launch` set it), else ``LOCAL_RANK`` + 1 as a floor, else the
    whole ``world`` (one node)."""
    if os.environ.get("LOCAL_WORLD_SIZE"):
        return int(os.environ["LOCAL_WORLD_SIZE"])
    if os.environ.get("LOCAL_RANK"):
        return int(os.environ["LOCAL_RANK"]) + 1
    return world


def check_cards(n_local: int, device_type: str, backend: str):
    """Refuse a node that is to run ``n_local`` NCCL ranks on fewer
    visible cards (JAX's ``make_mesh`` takes ``devices[:n]`` silently)."""
    if device_type != "cuda":
        return
    if not torch.cuda.is_available():
        raise RuntimeError("a data mesh on cuda needs CUDA; "
                           "torch.cuda.is_available() is False")
    have = torch.cuda.device_count()
    if backend == "nccl" and n_local > have:
        raise ValueError(f"{n_local} data-parallel ranks on this node need "
                         f"{n_local} cards; {have} visible")


def resolve_ranks(n_devices: Optional[int], device) -> int:
    """The rank count a ``--dp`` value asks for: N > 0 is N; below 0 (or
    None) means every visible card."""
    if n_devices is not None and n_devices > 0:
        return int(n_devices)
    if torch.device(device).type != "cuda":
        raise ValueError("--dp below 0 means every card; the CPU has none: "
                         "give the rank count")
    if not torch.cuda.is_available():
        raise RuntimeError("--dp below 0 needs CUDA")
    return torch.cuda.device_count()


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()
                              if dist.is_initialized() else 0))


def _init_group(backend: str, world: int, rank: int, init_method: str):
    if backend == "nccl":
        torch.cuda.set_device(_local_rank())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=GROUP_TIMEOUT)


def make_mesh(n_devices: Optional[int] = None, device=None,
              backend: Optional[str] = None) -> Mesh:
    """The rank's data mesh.

    Joins the process group that :func:`launch` or ``torchrun``
    (``WORLD_SIZE`` set: ``jax.distributed.initialize``'s counterpart, on
    one node or several) started; with neither, a one-rank group in this
    process.  ``n_devices``: the rank count wanted (checked against the
    group; None or below 0 takes the group's).  ``device``: the rank's
    device, ``cuda`` by default (``cuda:LOCAL_RANK`` when no index is
    given).  ``backend``: NCCL for CUDA, gloo for the CPU; gloo over CUDA
    tensors only when passed explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if not dist.is_initialized():
        env_world = os.environ.get("WORLD_SIZE")
        world = int(env_world) if env_world else 1
        want = (n_devices if n_devices is not None and n_devices > 0
                else world)
        if want != world:
            raise ValueError(
                f"make_mesh({want}) in one process: start {want} ranks with "
                f"parallel.launch or torchrun")
        backend = backend or _default_backend(dev.type)
        check_cards(node_ranks(world), dev.type, backend)
        if env_world:
            _init_group(backend, world, int(os.environ["RANK"]), "env://")
        else:
            _init_group(backend, 1, 0, f"tcp://localhost:{free_port()}")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices > 0 and n_devices != world:
        raise ValueError(f"make_mesh({n_devices}) inside a group of {world} "
                         f"ranks")
    used = dist.get_backend()
    if backend is not None and backend != used:
        raise ValueError(f"backend {backend!r} asked for, the group runs "
                         f"{used!r}")
    if dev.type == "cuda":
        if used != "nccl" and backend is None:
            raise ValueError(
                f"a {used} group over CUDA tensors: pass backend={used!r} "
                f"explicitly (NCCL is the default on cards)")
        check_cards(node_ranks(world), "cuda", used)
        if dev.index is None:
            dev = torch.device("cuda", _local_rank())
    return Mesh(rank, world, dev, used)


def _group_world() -> int:
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE") or 1)


def make_grid(n_data: int, n_axis: int, axis: str, device=None,
              backend: Optional[str] = None) -> Mesh:
    """The rank's (data x ``axis``) mesh of ``n_data * n_axis`` ranks.

    Joins the group as :func:`make_mesh` does, then makes one subgroup per
    row and per column of the grid: every rank calls ``dist.new_group``
    for every subgroup, in the same order, as the library requires.  Rank
    r sits at ``(r // n_axis, r % n_axis)``.  Refuses a grid of more
    ranks than the group has (JAX's oversubscription refusal) and one of
    fewer (a rank outside the grid would have no work)."""
    need = n_data * n_axis
    world = _group_world()
    if need != world:
        raise ValueError(f"mesh {n_data}x{n_axis} needs {need} ranks, have "
                         f"{world}")
    base = make_mesh(need, device=device, backend=backend)
    rank = base.rank
    d, a = divmod(rank, n_axis)
    data_group = axis_group = None
    if need > 1:
        for col in range(n_axis):   # the ranks of one axis coordinate
            g = dist.new_group([r * n_axis + col for r in range(n_data)],
                               timeout=GROUP_TIMEOUT)
            if col == a:
                data_group = g
        for row in range(n_data):   # the ranks of one data coordinate
            g = dist.new_group([row * n_axis + c for c in range(n_axis)],
                               timeout=GROUP_TIMEOUT)
            if row == d:
                axis_group = g
    return dataclasses.replace(base, axis_names=(DATA_AXIS, axis),
                               shape=(n_data, n_axis), coords=(d, a),
                               groups=(data_group, axis_group))


def _rank_entry(spec: str):
    """A launched rank (``python -m adaptiveisp_tpu_torch.parallel``):
    join the group of the environment torchrun's way, run the target."""
    import json

    target, backend, args = json.loads(spec)
    _init_group(backend, int(os.environ["WORLD_SIZE"]),
                int(os.environ["RANK"]), "env://")
    try:
        module, name = target.split(":")
        getattr(importlib.import_module(module), name)(*args)
        barrier()
    finally:
        dist.destroy_process_group()


class Ranks:
    """Ranks started by :func:`launch`; ``wait()`` blocks until they end
    and raises, naming the rank, if one failed (the others are stopped),
    or if they outlast ``timeout`` seconds (all are stopped)."""

    def __init__(self, target: str, procs):
        self.target, self.procs = target, procs

    def wait(self, timeout: Optional[float] = None):
        import time

        procs, failed = self.procs, {}
        end = None if timeout is None else time.monotonic() + timeout
        try:
            while not failed and any(p.poll() is None for p in procs):
                failed = {r: p.returncode for r, p in enumerate(procs)
                          if p.poll() not in (None, 0)}
                if end is not None and time.monotonic() > end:
                    raise TimeoutError(
                        f"{self.target} on {len(procs)} ranks: still "
                        f"running after {timeout} s; stopped")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        failed = failed or {r: p.returncode for r, p in enumerate(procs)
                            if p.returncode != 0}
        if failed:
            raise RuntimeError(f"{self.target} on {len(procs)} ranks: "
                               f"rank(s) {sorted(failed)} failed (exit "
                               f"{sorted(set(failed.values()))}); the "
                               f"others were stopped")


def launch(target: str, n: int, *args, device="cuda",
           backend: Optional[str] = None) -> Ranks:
    """Start ``module:function(*args)`` on ``n`` new ranks of this node;
    their :class:`Ranks` (``.wait()`` for them).

    Each rank is a fresh interpreter (this module run with ``-m``, the
    environment torchrun sets: RANK, WORLD_SIZE, LOCAL_RANK,
    LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT) inside an initialised
    process group: NCCL on ``n`` cards, or gloo with ``device="cpu"`` or
    an explicit ``backend``.  ``args`` must be JSON values."""
    import json
    import subprocess
    import sys

    dev = torch.device(device)
    backend = backend or _default_backend(dev.type)
    check_cards(n, dev.type, backend)
    spec = json.dumps([target, backend, list(args)])
    env = dict(os.environ, MASTER_ADDR="localhost",
               MASTER_PORT=str(free_port()), WORLD_SIZE=str(n),
               LOCAL_WORLD_SIZE=str(n),
               PYTHONPATH=os.pathsep.join(p for p in sys.path if p))
    return Ranks(target, [subprocess.Popen(
        [sys.executable, "-m", "adaptiveisp_tpu_torch.parallel", spec],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r))) for r in range(n)])


def cli_mesh(dp: int, device, target: str, argv: Optional[Sequence[str]],
             n_axis: int = 0, axis: Optional[str] = None):
    """A CLI's ``--dp`` (and a second axis): ``(mesh, launched)``.

    dp 0 and n_axis 0: ``(None, False)``.  n_axis > 0: a (data x ``axis``)
    mesh of ``max(dp, 1) x n_axis`` ranks (JAX's ``make_mesh_dp_*(max(1,
    dp), n)``); else a data mesh of ``dp`` ranks.  Inside a group (a
    launched rank, torchrun) or for one rank: ``(the mesh, False)``, on
    the group's backend (a caller that launched gloo ranks over CUDA
    tensors chose it).  Otherwise the CLI's ``target`` ("module:function")
    runs again with ``argv`` on the ranks (:func:`launch`) and this
    returns ``(None, True)`` after they end."""
    import sys

    if not dp and not n_axis:
        return None, False
    if n_axis:
        n_data = max(1, dp)
        n = n_data * n_axis
    else:
        n = resolve_ranks(dp, device)
    if dist.is_initialized() or os.environ.get("WORLD_SIZE") or n == 1:
        backend = dist.get_backend() if dist.is_initialized() else None
        if n_axis:
            return make_grid(n_data, n_axis, axis, device=device,
                             backend=backend), False
        return make_mesh(n, device=device, backend=backend), False
    argv = list(sys.argv[1:] if argv is None else argv)
    launch(target, n, argv, device=device).wait()
    return None, True


# --------------------------------------------------------------------- #
# collectives
# --------------------------------------------------------------------- #
def barrier():
    if not dist.is_initialized():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def sync_global_devices(mesh: Optional[Mesh]):
    """Barrier over the ranks of ``mesh`` (JAX's ``sync_global_devices``):
    rank 0 writes a checkpoint, then everyone passes."""
    if mesh is not None:
        barrier()


def all_reduce(mesh: Mesh, x: torch.Tensor, op: str = "sum",
               axis: str = DATA_AXIS) -> torch.Tensor:
    """The sum (or "mean") of ``x`` over the ranks of ``axis`` (the data
    ranks by default), a new tensor."""
    y = x.detach().clone()
    if mesh.axis_size(axis) > 1:
        dist.all_reduce(y, group=mesh.group(axis))
    if op == "mean":
        y = y / mesh.axis_size(axis)
    return y


def all_gather(mesh: Mesh, x: torch.Tensor, axis: str = DATA_AXIS,
               dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` of ``axis`` (the data ranks by default)
    concatenated along ``dim`` in coordinate order.  NCCL gathers; gloo
    sums zero-padded blocks (exact, and gloo reduces CUDA tensors)."""
    x = x.detach().contiguous()
    n = mesh.axis_size(axis)
    if n == 1:
        return x.clone()
    group = mesh.group(axis)
    if mesh.backend == "nccl":
        out = x.new_empty((n,) + tuple(x.shape))
        dist.all_gather_into_tensor(out, x, group=group)
    else:
        dtype = x.dtype
        work = x.to(torch.float64) if dtype == torch.bool else x
        out = work.new_zeros((n,) + tuple(work.shape))
        out[mesh.axis_rank(axis)] = work
        dist.all_reduce(out, group=group)
        out = out.to(dtype)
    return torch.cat(out.unbind(0), dim=dim)


def broadcast_object(mesh: Optional[Mesh], obj):
    """Rank 0's ``obj`` on every rank (e.g. a save directory chosen once,
    or the metrics rank 0 validated)."""
    if mesh is None or mesh.size == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def on_main(mesh: Optional[Mesh], fn):
    """``fn()`` run on rank 0 alone, its result on every rank: one
    decision (validation metrics, the best checkpoint, the early stop)
    that every rank then follows alike."""
    if mesh is None or mesh.size == 1:
        return fn()
    return broadcast_object(mesh, fn() if mesh.is_main else None)


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group whose backward sums the gradients over the group
    (torch ``SyncBatchNorm``'s differentiation of its statistics)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


# --------------------------------------------------------------------- #
# the step's data group: global BatchNorm statistics and dropout masks
# --------------------------------------------------------------------- #
@contextlib.contextmanager
def data_parallel(mesh: Optional[Mesh]):
    """While active, train-mode BatchNorm takes global statistics and
    dropout draws its masks at the global batch (``policy/nets.py``).  A
    one-rank mesh changes nothing."""
    token = _ACTIVE.set(mesh if mesh is not None and mesh.data_size > 1
                        else None)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active() -> Optional[Mesh]:
    return _ACTIVE.get()


def global_moments(mesh: Mesh, x: torch.Tensor, dims):
    """(mean, biased variance) over ``dims`` of the global batch, as flax
    computes them under ``pmean``: the local means of x and x² (float32),
    one differentiable all-reduce over the data ranks,
    var = max(E[x²] - E[x]², 0)."""
    xf = x.float()
    local = torch.stack([xf.mean(dims), (xf * xf).mean(dims)])
    total = (_AllReduceSum.apply(local, mesh.group(DATA_AXIS))
             / mesh.data_size)
    mean, mean2 = total[0], total[1]
    return mean, torch.clamp(mean2 - mean * mean, min=0.0)


def global_rows_mask(mesh: Mesh, like: torch.Tensor, keep_prob: float,
                     generator: torch.Generator) -> torch.Tensor:
    """A Bernoulli(keep_prob) mask drawn at the global batch (rank count ×
    the rank's rows) from ``generator``, the rank's rows of it: the mask
    the single-device step draws for these rows."""
    n, r = like.shape[0], mesh.data_rank
    full = torch.empty((n * mesh.data_size,) + tuple(like.shape[1:]),
                       dtype=like.dtype, device=like.device)
    full.bernoulli_(keep_prob, generator=generator)
    return full[r * n:(r + 1) * n]


# --------------------------------------------------------------------- #
# sharding and replication
# --------------------------------------------------------------------- #
def data_sharding(mesh: Mesh, n: int) -> slice:
    """The rank's contiguous rows of a batch of ``n`` (JAX's ``P('data')``
    on the leading axis): its block by its data coordinate."""
    size, r = mesh.data_size, mesh.data_rank
    if n % size:
        raise ValueError(f"batch {n} does not divide over {size} data "
                         f"ranks")
    per = n // size
    return slice(r * per, (r + 1) * per)


def shard_batch(mesh: Mesh, batch):
    """The rank's rows of every array in ``batch`` (a tensor, an array, or
    a tuple / list of them), as tensors on the rank's device."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(mesh, v) for v in batch)
    rows = batch[data_sharding(mesh, batch.shape[0])]
    if isinstance(rows, np.ndarray):
        rows = torch.from_numpy(np.ascontiguousarray(rows))
    return rows.to(mesh.device)


# --------------------------------------------------------------------- #
# image rows over the spatial axis
# --------------------------------------------------------------------- #
def row_bounds(height: int, n: int, i: int) -> tuple:
    """Rows ``[lo, hi)`` of part ``i`` of ``n`` of a frame of ``height``
    rows: blocks of ``ceil(height / n)``, the last ones shorter or empty,
    as GSPMD pads an uneven dimension."""
    per = -(-height // n)
    lo = min(height, i * per)
    return lo, min(height, lo + per)


@dataclasses.dataclass(frozen=True)
class Rows:
    """The rank's block of a frame's rows over the ``spatial`` axis of
    ``mesh`` (:func:`row_bounds`), for a frame of ``height`` rows."""

    mesh: Mesh
    height: int

    @property
    def parts(self) -> int:
        return self.mesh.axis_size(SPATIAL_AXIS)

    @property
    def bounds(self) -> tuple:
        return row_bounds(self.height, self.parts,
                          self.mesh.axis_rank(SPATIAL_AXIS))


def spatial_image_sharding(mesh: Mesh, n: int, height: int) -> tuple:
    """(batch slice, row slice) of the rank's block of an NHWC batch of
    ``n`` frames of ``height`` rows: batch over ``data``, rows over
    ``spatial`` (JAX's ``P('data', 'spatial', None, None)``)."""
    return data_sharding(mesh, n), slice(*Rows(mesh, height).bounds)


def shard_image(mesh: Mesh, img) -> torch.Tensor:
    """The rank's block of an NHWC batch (a tensor or an array), on the
    rank's device."""
    b, r = spatial_image_sharding(mesh, img.shape[0], img.shape[1])
    block = img[b, r]
    if isinstance(block, np.ndarray):
        block = torch.from_numpy(np.ascontiguousarray(block))
    return block.to(mesh.device)


def gather_rows(mesh: Mesh, block: torch.Tensor, height: int
                ) -> torch.Tensor:
    """The whole frames' rows on every rank of the spatial axis, from
    each rank's block of :func:`shard_image` (the batch stays the rank's
    data rows)."""
    parts = mesh.axis_size(SPATIAL_AXIS)
    per = -(-height // parts)
    pad = block.new_zeros((block.shape[0], per) + tuple(block.shape[2:]))
    pad[:, :block.shape[1]] = block
    full = all_gather(mesh, pad, axis=SPATIAL_AXIS, dim=1)
    return full[:, :height]


def check_rows(rows: Rows, halo: int):
    """Refuse a split whose shortest block has fewer rows than ``halo``
    (its neighbours' halos would reach past it) or none."""
    lo, hi = row_bounds(rows.height, rows.parts, rows.parts - 1)
    if hi - lo < max(halo, 1):
        raise ValueError(
            f"{rows.height} rows over {rows.parts} spatial ranks leave a "
            f"block of {hi - lo} rows; a stage needs {max(halo, 1)}: use "
            f"fewer spatial ranks")


def with_halo(rows: Rows, block: torch.Tensor, halo: int, wrap: bool):
    """``(slab, top, bottom)``: the rank's block with ``halo`` rows of
    its neighbours above (``top`` rows) and below (``bottom``).  At the
    frame's first and last rows ``wrap`` takes the rows from the other
    end (a circular stage), else adds none (a stage whose frame edge is
    its own).  One all-gather of every rank's first and last ``halo``
    rows over the spatial axis."""
    parts = rows.parts
    if halo == 0 or parts == 1:
        return block, 0, 0
    check_rows(rows, halo)
    s = rows.mesh.axis_rank(SPATIAL_AXIS)
    edges = torch.stack([block[:, :halo], block[:, -halo:]])
    every = all_gather(rows.mesh, edges[None], axis=SPATIAL_AXIS)
    above = every[s - 1, 1] if s > 0 or wrap else None
    below = every[(s + 1) % parts, 0] if s < parts - 1 or wrap else None
    parts_ = [t for t in (above, block, below) if t is not None]
    return (torch.cat(parts_, dim=1), 0 if above is None else halo,
            0 if below is None else halo)


def replicate(mesh: Optional[Mesh], module: torch.nn.Module):
    """Rank 0's parameters and buffers on every rank (a broadcast)."""
    if mesh is None or mesh.size == 1:
        return module
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0)
    return module


def all_reduce_grads(mesh: Mesh, params, average: bool = True):
    """One flat all-reduce of the gradients of ``params`` (a missing
    gradient counts as zeros, as the port's optimizers take it), summed
    or averaged over the data ranks, written back as the parameters'
    grads."""
    params = [p for p in params if p.requires_grad]
    by_dtype = {}
    for p in params:
        by_dtype.setdefault(p.dtype, []).append(p)
    for group in by_dtype.values():
        flat = torch.cat([(torch.zeros_like(p) if p.grad is None
                           else p.grad).reshape(-1) for p in group])
        if mesh.data_size > 1:
            dist.all_reduce(flat, group=mesh.group(DATA_AXIS))
        if average:
            flat /= mesh.data_size
        off = 0
        for p in group:
            n = p.numel()
            p.grad = flat[off:off + n].view_as(p)
            off += n


def sync_gradients(optimizer: torch.optim.Optimizer, mesh: Optional[Mesh],
                   average: bool = True):
    """Make ``optimizer`` all-reduce its parameters' gradients before each
    step (a step pre-hook, so before the clip and the update).  Idempotent:
    a trainer calls it every step and after building a new optimizer."""
    if mesh is None or getattr(optimizer, "_data_mesh", None) is mesh:
        return optimizer
    params = [p for g in optimizer.param_groups for p in g["params"]]

    def hook(opt, args, kwargs):
        all_reduce_grads(mesh, params, average=average)

    optimizer.register_step_pre_hook(hook)
    optimizer._data_mesh = mesh
    return optimizer


if __name__ == "__main__":
    import sys

    from adaptiveisp_tpu_torch import parallel as _parallel

    _parallel._rank_entry(sys.argv[1])
