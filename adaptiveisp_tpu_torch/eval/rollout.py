"""Adaptive ISP rollout (port of ``adaptiveisp_tpu/eval/rollout.py``).

A Python loop over the steps with a stop mask per sample: once a sample's
stopped bit is set its image and state stop updating and its selection reads
-1.  With ``early_exit`` a step at which every sample has already stopped
gives zero pdfs and parameters, as JAX's ``lax.cond`` does; the step still
runs, so the loop reads nothing back and uploads nothing: a forced pipeline
goes to the device once, before the loop.

:class:`ServedRollout` replays the loop from one CUDA graph per input shape
where capture is valid (``AdaptiveISP`` serves through it).

Spans and counters (only while a profiler records, ``obs/profile.py``):
``rollout`` around an eager loop and ``rollout.step`` around each step,
counted as ``rollout.eager``; ``rollout.replay`` around a replay (the
copy-in, the replay and the copy-out), counted as ``rollout.graph``.
"""

from __future__ import annotations

import collections
import itertools
import threading
from typing import NamedTuple, Optional, Sequence

import torch

from adaptiveisp_tpu_torch.obs.profile import count, span
from adaptiveisp_tpu_torch.ops.cuda import build
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


def upload(host: torch.Tensor, device) -> torch.Tensor:
    """``host`` on ``device`` without the host waiting for the card's
    stream: on the card through pinned memory, whose caching allocator keeps
    the block from reuse until the copy has run."""
    if torch.device(device).type != "cuda":
        return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)


def forced_ids(pipeline, steps: int, device) -> Optional[torch.Tensor]:
    """None when every step is the agent's choice (-1 each, or None), else
    the [steps] int32 forced ids on ``device`` (a tensor is taken as it
    is)."""
    if pipeline is None:
        return None
    if isinstance(pipeline, torch.Tensor):
        ids = pipeline.to(device=device, dtype=torch.int32)
    else:
        pipe = [int(p) for p in pipeline]
        if all(p < 0 for p in pipe):
            return None
        ids = upload(torch.tensor(pipe, dtype=torch.int32), device)
    if ids.shape != (steps,):
        raise ValueError(f"pipeline has {ids.shape[0]} entries, "
                         f"noises {steps} steps")
    return ids


def _steps(agent, image, noises, states, forced, record_steps, render,
           early_exit) -> RolloutResult:
    steps, n = noises.shape[0], image.shape[0]
    early_exit = early_exit and not record_steps
    img, st = image, states
    stop = torch.zeros((n,), dtype=torch.float32, device=image.device)
    sels, pdfs, params, imgs = [], [], [], []
    with span("rollout"):
        for t in range(steps):
            with span("rollout.step"):
                stopped = stop > 0
                out, new_states, _, _, _, info = agent(
                    img, noises[t], st, 1.0, train=False,
                    selected_filter_id=None if forced is None else forced[t],
                    render=render)
                img = torch.where(stopped[:, None, None, None], img, out)
                st = torch.where(stopped[:, None], st, new_states)
                sels.append(torch.where(stopped, torch.full_like(
                    info["selected_filter"], -1), info["selected_filter"]))
                pdf = info["pdf"]
                par = torch.cat([p.reshape(n, -1)
                                 for p in info["filter_params"]], dim=-1)
                if early_exit:
                    done = stopped.all()
                    pdf, par = pdf.masked_fill(done, 0), par.masked_fill(
                        done, 0)
                pdfs.append(pdf)
                params.append(par)
                stop = torch.maximum(stop, st[:, STATE_STOPPED_DIM])
                if record_steps:
                    imgs.append(img)
    return RolloutResult(img, st, None, torch.stack(sels), torch.stack(pdfs),
                         torch.stack(imgs) if record_steps else None,
                         torch.stack(params))


@torch.no_grad()
def rollout(agent, image, noises, states, pipeline: Sequence[int],
            record_steps: bool = False, render: str = "blend",
            early_exit: bool = True) -> RolloutResult:
    """Run ``len(noises)`` agent steps in eval mode, op by op.

    image [N, H, W, 3]; noises [steps, N, z_dim]; states [N, S]; pipeline:
    one forced filter id per step or -1 for the agent's choice (a sequence
    of ints, or a [steps] int tensor).  Early exit is off when recording
    steps, whose consumers read the pdfs of every step.
    """
    forced = forced_ids(pipeline, noises.shape[0], image.device)
    count("rollout.eager")
    return _steps(agent, image, noises, states, forced, record_steps, render,
                  early_exit)


class _Graph(NamedTuple):
    graph: torch.cuda.CUDAGraph
    image: torch.Tensor          # the static inputs
    noises: torch.Tensor
    forced: Optional[torch.Tensor]
    out: RolloutResult           # the static outputs
    launches: dict               # build.LAUNCHES of one replay


class ServedRollout:
    """The served rollout, blend render from all-zero states: for a key of
    (input shapes, dtype and device, whether a filter is forced, the
    agent's tensors) it runs eagerly on the first call, captures the loop
    as one CUDA graph on the second (after a warm-up on a side stream, as
    ``torch.cuda.graphs`` documents) and replays it from then on.  Capture
    is used only where it is valid: CUDA tensors that need no gradient, no
    recorded steps, not inside a capture, ``torch.compile`` or
    ``torch.export`` (fake tensors); anything else runs eagerly.  At most
    ``KEYS`` keys are kept, the least recently used evicted.  A replay's
    results are copies the caller owns; ``build.LAUNCHES`` gains the
    kernels captured in one replay."""

    KEYS = 4

    def __init__(self):
        self._keys: collections.OrderedDict = collections.OrderedDict()
        self._lock = threading.Lock()

    def __call__(self, agent, image, noises, pipeline,
                 record_steps: bool = False) -> RolloutResult:
        if record_steps or not _capturable(image, noises):
            return rollout(agent, image, noises, _zero_states(agent, image),
                           pipeline, record_steps=record_steps)
        forced = forced_ids(pipeline, noises.shape[0], image.device)
        key = (tuple(image.shape), tuple(noises.shape), image.device,
               image.dtype, forced is not None,
               tuple(t.data_ptr() for t in itertools.chain(
                   agent.parameters(), agent.buffers())))
        with self._lock:
            seen = key in self._keys
            entry = self._keys.pop(key, None)
            if not seen:    # the first call runs eagerly
                self._remember(key, None)
                return rollout(agent, image, noises,
                               _zero_states(agent, image), forced)
            if entry is None:
                entry = _capture(agent, image, noises, forced)
            self._remember(key, entry)
            return _replay(entry, image, noises, forced)

    def _remember(self, key, entry):
        self._keys[key] = entry
        while len(self._keys) > self.KEYS:
            self._keys.popitem(last=False)


def _zero_states(agent, image):
    return torch.zeros((image.shape[0], agent.cfg.num_state_dim),
                       dtype=torch.float32, device=image.device)


def _capturable(*tensors) -> bool:
    return (tensors[0].is_cuda
            and all(type(t) is torch.Tensor and not t.requires_grad
                    for t in tensors)
            and not torch.compiler.is_compiling()
            and not torch.cuda.is_current_stream_capturing())


@torch.no_grad()
def _capture(agent, image, noises, forced) -> _Graph:
    image, noises = image.clone(), noises.clone()
    forced = None if forced is None else forced.clone()

    def run():
        return _steps(agent, image, noises, _zero_states(agent, image),
                      forced, False, "blend", True)

    dev = image.device
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = dict(build.LAUNCHES)
    with torch.cuda.graph(graph):
        out = run()
    launches = {k: n - before.get(k, 0) for k, n in build.LAUNCHES.items()}
    build.LAUNCHES.update(before)   # the capture ran nothing
    return _Graph(graph, image, noises, forced, out, launches)


def _replay(g: _Graph, image, noises, forced) -> RolloutResult:
    count("rollout.graph")
    with span("rollout.replay"):
        g.image.copy_(image)
        g.noises.copy_(noises)
        if forced is not None:
            g.forced.copy_(forced)
        g.graph.replay()
        for k, n in g.launches.items():
            build.LAUNCHES[k] = build.LAUNCHES.get(k, 0) + n
        return g.out._replace(**{
            k: v.clone() for k, v in g.out._asdict().items()
            if isinstance(v, torch.Tensor)})
