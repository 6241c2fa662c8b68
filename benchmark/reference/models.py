"""The plain reference's networks and passes, built from a configuration
file of ``benchmark/configs``.

Everything under ``benchmark/reference`` is plain PyTorch: a frozen copy of
the port's plain code at the commit that defined the benchmark, with the
port's kernels, meshes and sharded paths taken out (the denoise filter runs
the plain NLM chain).  It imports nothing of the port and takes no weight
from it: the benchmark makes the weights and hands the same to both.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from benchmark.reference.config import Config
from benchmark.reference.detect.model import DetectionModel, decode_predictions
from benchmark.reference.detect.nms import non_max_suppression
from benchmark.reference.detect.spec import load_spec
from benchmark.reference.policy.agent import Agent
from benchmark.reference.policy.states import get_initial_states, get_noise
from benchmark.reference.rollout import rollout

DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def config(cfg_file: Dict) -> Config:
    return Config(**{k: tuple(v) if isinstance(v, list) else v
                     for k, v in cfg_file["agent_config"].items()})


def spec(cfg_file: Dict) -> Dict:
    return load_spec(cfg_file["detector"]["spec"])


def agent(cfg_file: Dict, state_dict=None, device="meta") -> Agent:
    """The agent with ``state_dict`` on ``device``; without one, the agent
    on the meta device, whose state dict gives the shapes."""
    with torch.device("meta"):
        net = Agent(config(cfg_file))
    if state_dict is None:
        return net
    net = net.to_empty(device=device)
    net.load_state_dict(state_dict)
    return net.eval()


def detector(cfg_file: Dict, state_dict=None, device="meta",
             dtype: str = "float32") -> DetectionModel:
    """As :func:`agent`, for the detector."""
    with torch.device("meta"):
        net = DetectionModel(spec(cfg_file), dtype=DTYPES[dtype])
    if state_dict is None:
        return net
    net = net.to_empty(device=device)
    net.load_state_dict(state_dict)
    return net.eval()


def rollout_inputs(cfg: Config, n: int, steps: int, noise_seed: int, device):
    """(noises [steps, N, z_dim], states [N, S]) as the served path draws
    them: one host RandomState per batch, a draw per step."""
    rng = np.random.RandomState(noise_seed)
    noises = np.stack([get_noise(rng, n, cfg.z_dim, cfg.z_type)
                       for _ in range(steps)])
    states = get_initial_states(n, cfg.num_state_dim)
    return (torch.as_tensor(noises, device=device),
            torch.as_tensor(states, device=device))


@torch.no_grad()
def adaptive_rollout(net: Agent, images, steps: int, noise_seed: int,
                     render: str = "blend"):
    noises, states = rollout_inputs(net.cfg, images.shape[0], steps,
                                    noise_seed, images.device)
    return rollout(net, images, noises, states, [-1] * steps, render=render)


@torch.no_grad()
def detect(net: DetectionModel, images, nms: Dict, spec_: Dict):
    preds = decode_predictions(net(images), spec_)
    return non_max_suppression(preds, **nms)


def filter_index(cfg_file: Dict, name: str) -> int:
    filters: Sequence[str] = cfg_file["agent_config"]["filters"]
    return list(filters).index(name) if name in filters else -1
