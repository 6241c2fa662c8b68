"""The served rollout replayed from a CUDA graph (``eval.rollout.
ServedRollout`` behind ``AdaptiveISP.process_with_trace``), on the card
(marked ``cuda``; each skips without one), at 2 x 64 x 64 for the fast
roster and the default one, whose denoise puts K1 in the graph:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_rollout_graph.py

The replay equals the eager loop bit for bit, hands back tensors the caller
owns, keeps a graph per shape (the least recently used evicted past
``KEYS``), counts the captured K1 launches on every replay and makes no
synchronizing call.
"""

import numpy as np
import pytest
import torch

from adaptiveisp_tpu_torch import api
from adaptiveisp_tpu_torch.config import Config
from adaptiveisp_tpu_torch.configs.config_fast_filters import cfg as FAST
from adaptiveisp_tpu_torch.eval.rollout import ServedRollout, _Graph
from adaptiveisp_tpu_torch.ops.cuda import build

STEPS = 5
ROSTERS = {"fast": FAST, "default": Config()}
FIELDS = ("image", "states", "selected", "pdfs", "params")


@pytest.fixture(scope="module", params=sorted(ROSTERS))
def isp(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the rollout's graph is captured on "
                    "the card")
    torch.manual_seed(0)
    return api.load_adaptive_isp(cfg=ROSTERS[request.param], steps=STEPS,
                                 device="cuda")


def _images(seed, n=2, size=64):
    return torch.from_numpy(np.random.RandomState(seed).uniform(
        0.02, 0.98, (n, size, size, 3)).astype(np.float32)).cuda()


def _served(isp, x, seed):
    return isp.process_with_trace(x, seed=seed, record_steps=False)


def _graphs(isp):
    return [k for k, v in isp._served._keys.items() if isinstance(v, _Graph)]


def _copy(res):
    return {f: getattr(res, f).clone() for f in FIELDS}


def _equal(res, want):
    return all(torch.equal(getattr(res, f), want[f]) for f in FIELDS)


@pytest.mark.cuda
def test_replay_equals_the_eager_loop(isp):
    isp._served = ServedRollout()
    x = _images(1)
    eager = _copy(_served(isp, x, seed=3))
    assert not _graphs(isp)
    for _ in range(2):   # the capturing call, then a plain replay
        assert _equal(_served(isp, x, seed=3), eager)
    assert len(_graphs(isp)) == 1
    assert _equal(isp.process_with_trace(x, seed=3), eager)   # recorded:
    assert len(_graphs(isp)) == 1                             # eager


@pytest.mark.cuda
def test_results_belong_to_the_caller(isp):
    isp._served = ServedRollout()
    x = _images(2)
    for seed in (4, 5):
        _served(isp, x, seed)
    first = _served(isp, x, seed=6)
    kept = _copy(first)
    second = _served(isp, _images(7), seed=8)
    assert _equal(first, kept)
    assert not _equal(second, kept)


@pytest.mark.cuda
def test_a_graph_per_shape_and_the_oldest_evicted(isp):
    isp._served = ServedRollout()
    sizes = [64, 48, 32, 56, 40][:ServedRollout.KEYS + 1]
    for size in sizes:
        x = _images(size, size=size)
        _served(isp, x, seed=1)
        _served(isp, x, seed=2)
    shapes = [k[0] for k in _graphs(isp)]
    assert shapes == [(2, s, s, 3) for s in sizes[1:]]   # 64 evicted
    _served(isp, _images(3), seed=1)   # 64 again: a first call, eager,
    # remembered in the place of the next oldest
    assert [k[0] for k in _graphs(isp)] == [(2, s, s, 3) for s in sizes[2:]]
    assert len(isp._served._keys) == ServedRollout.KEYS


@pytest.mark.cuda
def test_each_replay_counts_the_captured_launches(isp):
    isp._served = ServedRollout()
    x = _images(4)
    for seed in (1, 2):
        _served(isp, x, seed)
    denoise = "denoise" in isp.cfg.filters
    for _ in range(3):
        before = dict(build.LAUNCHES)
        _served(isp, x, seed=3)
        grown = build.LAUNCHES["nlm_gray_fwd"] - before["nlm_gray_fwd"]
        assert grown == (STEPS if denoise else 0)


@pytest.mark.cuda
def test_a_replay_makes_no_synchronizing_call(isp):
    isp._served = ServedRollout()
    x = _images(5)
    for seed in (1, 2):
        _served(isp, x, seed)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _served(isp, x, seed=3)
        _served(isp, x, seed=4)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
