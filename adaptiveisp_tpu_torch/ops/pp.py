"""Pipeline-parallel (pp) streaming ISP render over a (data x pipe) mesh
(port of ``adaptiveisp_tpu/ops/pp.py``).

Stage i of a scripted filter chain lives on pipe rank i, and a stream of M
frames (microbatches) flows through the ranks: the GPipe schedule, in
which at tick t rank 0 takes frame t, every rank applies its stage to the
frame it holds and passes the result to the next rank, and the last
rank's results of ticks S-1 ... S-2+M are the finished frames.  After the
S-1 ticks of fill all S stages run at once on S consecutive frames.

Each rank is a process (``parallel.make_grid``), so a rank runs only its
own ticks: it receives frame m from the rank before it (rank 0 reads it),
applies its stage, and sends the result on while it waits for frame m+1.
The hop is a point-to-point send: NCCL sends from card to card; gloo
sends host tensors, so on gloo a CUDA frame is copied to host memory for
the hop and back to the card after it (the stages still run on the
card).  The result equals the sequential per-frame render
(``render_pipeline(..., allow_fused=False)``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from adaptiveisp_tpu_torch import parallel
from adaptiveisp_tpu_torch.ops.bank import get_spec, render_fixed


class _Hop:
    """Point-to-point sends and receives of frames between pipe ranks:
    on the device with NCCL or for CPU tensors, through host memory for
    CUDA tensors on gloo."""

    def __init__(self, mesh, like: torch.Tensor):
        self.staged = mesh.backend != "nccl" and like.is_cuda
        self.device = like.device
        self.pending = None

    def send(self, x: torch.Tensor, dst: int):
        self.wait()
        buf = x.cpu() if self.staged else x.contiguous()
        self.pending = (dist.isend(buf, dst), buf)

    def recv(self, like: torch.Tensor, src: int) -> torch.Tensor:
        buf = torch.empty(like.shape, dtype=like.dtype,
                          device="cpu" if self.staged else like.device)
        dist.recv(buf, src)
        return buf.to(self.device) if self.staged else buf

    def wait(self):
        if self.pending is not None:
            self.pending[0].wait()
            self.pending = None


def make_pipelined_render(cfg, mesh, names: Sequence[str]):
    """The pipeline-parallel scripted renderer on a (data x pipe) mesh.

    names: the chain, one stage per pipe rank (refused unless its length
    is the pipe size).  Returns ``fn(frames [M,n,H,W,3], params_list)``:
    ``frames`` the rank's data rows of M microbatches (pipe rank 0 reads
    them; the others take only their shape), ``params_list[i]`` stage i's
    parameter vector [P_i].  The last pipe rank returns the finished
    [M,n,H,W,3]; the others return None."""
    names = tuple(names)
    n_pipe = mesh.axis_size(parallel.PIPE_AXIS)
    if len(names) != n_pipe:
        raise ValueError(
            f"{len(names)} stages need a pipe axis of {len(names)}, "
            f"mesh has {n_pipe}")
    i = mesh.axis_rank(parallel.PIPE_AXIS)
    name, spec = names[i], get_spec(cfg, names[i])
    ranks = mesh.axis_ranks(parallel.PIPE_AXIS)

    @torch.no_grad()
    def fn(frames, params_list):
        m, n = frames.shape[:2]
        p = torch.as_tensor(params_list[i], dtype=torch.float32,
                            device=mesh.device)
        p = p[None, :spec.n_params].expand(n, spec.n_params)
        hop = _Hop(mesh, torch.empty(0, device=mesh.device))
        like = frames[0]
        out = [] if i == n_pipe - 1 else None
        for t in range(m):
            x = (frames[t].to(mesh.device) if i == 0
                 else hop.recv(like, ranks[i - 1]))
            y = render_fixed(cfg, x, name, p)
            if out is not None:
                out.append(y)
            else:
                hop.send(y, ranks[i + 1])
        hop.wait()
        return None if out is None else torch.stack(out)

    return fn
