"""The port's fixed-pipeline optimiser against the JAX package's.

The 1-level detector of ``tests/test_fixed_pipeline.py`` (32 px, nc 4) with
seeded flax variables on both sides (``convert.yolo_from_flax``), dark
seeded images with one box each.  Held against JAX on the CPU:
``init_raw_params`` exactly; ``render_with_raw_params`` (1e-5); the
curriculum's masked phase, 5 steps of ``make_fixed_pipeline_step`` with the
luminance mask under Adam (raw parameters 1e-5, losses 1e-5 relative; the
masked stage bit for bit unchanged on both sides); optax's cosine schedule;
and 6 steps of ``optimize_fixed_pipeline`` (two phases, fresh moments, the
cosine schedule, the smoothed best iterate over two cached batches):
history 1e-4 relative, the returned raw parameters and their squashed
values 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from adaptiveisp_tpu.config import Config as JConfig
from adaptiveisp_tpu.detect.loss import LossHyp as JLossHyp
from adaptiveisp_tpu.train import fixed_pipeline as jfp
from adaptiveisp_tpu_torch.config import Config
from adaptiveisp_tpu_torch.convert import yolo_from_flax
from adaptiveisp_tpu_torch.detect.loss import LossHyp
from adaptiveisp_tpu_torch.detect.model import DetectionModel
from adaptiveisp_tpu_torch.train import fixed_pipeline as tfp
from adaptiveisp_tpu_torch.train.optim import adam, cosine_decay_schedule
from test_torch_detect import flax_yolo_variables
from torch_suite import cheap_xla, one_torch_thread  # noqa: F401

CFG, JCFG = Config(), JConfig(use_pallas=False)
SPEC = {   # tests/test_fixed_pipeline.py's
    "nc": 4,
    "anchors": [[10, 14, 23, 27, 37, 58]],
    "backbone": [[-1, 1, "Conv", [8, 3, 2]],
                 [-1, 1, "Conv", [16, 3, 2]],
                 [-1, 1, "Conv", [16, 3, 2]],
                 [-1, 1, "Conv", [16, 3, 2]]],
    "head": [[[3], 1, "Detect", ["nc", "anchors"]]],
}
ANCHORS = [np.asarray(SPEC["anchors"][0], np.float32).reshape(-1, 2) / 16]
HYP = dict(obj=1.0 * (32 / 640) ** 2)
CHAIN = ("exposure", "improved_wb", "gamma")   # luminance, colour, luminance


@pytest.fixture(scope="module")
def detectors():
    jm, v = flax_yolo_variables(SPEC, 21)
    port = DetectionModel(SPEC)
    port.load_state_dict(yolo_from_flax(v["params"], v["batch_stats"],
                                        SPEC))
    return jm, v, port.eval()


def _batch(seed):
    rng = np.random.RandomState(seed)
    imgs = (rng.rand(2, 32, 32, 3) * 0.1).astype(np.float32)
    imgs[:, 10:22, 10:22] += 0.15
    targets = np.array([[[1, 0.5, 0.5, 0.4, 0.4]], [[2, 0.45, 0.5, 0.3,
                                                      0.5]]], np.float32)
    return imgs, targets, np.ones((2, 1), bool)


def _jax(b):
    return tuple(jnp.asarray(a) for a in b)


def _port(b):
    return tuple(torch.from_numpy(a) for a in b)


def _np_raw(raw):
    return {k: np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)
            for k, v in raw.items()}


def test_init_and_render_match_jax():
    chain = ("exposure", "improved_wb", "ccm", "gamma", "sharpen")
    rt, rj = tfp.init_raw_params(CFG, chain), jfp.init_raw_params(JCFG, chain)
    assert list(rt) == list(rj)
    for k in rj:
        np.testing.assert_array_equal(rt[k].numpy(), np.asarray(rj[k]))
    rng = np.random.RandomState(2)
    img = (rng.rand(2, 32, 32, 3) * 0.9 + 0.1).astype(np.float32)
    # zero raw features: exposure 0 EV and gamma 1, the identity
    ident = tfp.render_with_raw_params(
        CFG, torch.from_numpy(img), ("exposure", "gamma"),
        tfp.init_raw_params(CFG, ("exposure", "gamma")))
    np.testing.assert_allclose(ident.numpy(), img, rtol=1e-4, atol=1e-5)
    raw = {k: (np.asarray(v) + rng.normal(0, 0.3, v.shape)).astype(
        np.float32) for k, v in rj.items()}
    want = jfp.render_with_raw_params(JCFG, jnp.asarray(img), chain,
                                      {k: jnp.asarray(v)
                                       for k, v in raw.items()})
    got = tfp.render_with_raw_params(CFG, torch.from_numpy(img), chain,
                                     {k: torch.from_numpy(v)
                                      for k, v in raw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_cosine_schedule_matches_optax():
    want = optax.cosine_decay_schedule(0.01, 10, alpha=0.1)
    got = cosine_decay_schedule(0.01, 10, alpha=0.1)
    for t in range(14):
        np.testing.assert_allclose(got(t), float(want(t)), rtol=1e-6)


def test_masked_phase_matches_jax(detectors):
    """The curriculum's first phase: Adam on the masked gradient moves the
    luminance stages and leaves improved_wb's raw parameters bit for bit."""
    jm, v, port = detectors
    mask = {f"{i}_{n}": 1.0 if n in jfp.LUMINANCE_STAGES else 0.0
            for i, n in enumerate(CHAIN)}
    tx = optax.adam(0.1)
    jstep, _ = jfp.make_fixed_pipeline_step(
        JCFG, CHAIN, jm, ANCHORS, JLossHyp(**HYP), tx,
        grad_mask={k: jnp.float32(m) for k, m in mask.items()})
    tstep, _ = tfp.make_fixed_pipeline_step(CFG, CHAIN, port, ANCHORS,
                                            LossHyp(**HYP), grad_mask=mask)
    rj = jfp.init_raw_params(JCFG, CHAIN)
    rt = tfp.init_raw_params(CFG, CHAIN)
    sj, opt = tx.init(rj), adam(0.1)(list(rt.values()))
    b = _batch(1)
    for _ in range(5):
        rj, sj, lj = jstep(rj, sj, v, *_jax(b))
        lt = tstep(rt, opt, *_port(b))
        np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
        for k, want in _np_raw(rj).items():
            np.testing.assert_allclose(rt[k].detach().numpy(), want,
                                       rtol=0, atol=1e-5, err_msg=k)
    init = tfp.init_raw_params(CFG, CHAIN)
    assert torch.equal(rt["1_improved_wb"].detach(), init["1_improved_wb"])
    assert np.array_equal(np.asarray(rj["1_improved_wb"]),
                          init["1_improved_wb"].numpy())
    assert (rt["0_exposure"] - init["0_exposure"]).abs().max() > 0


def test_optimize_fixed_pipeline_matches_jax(detectors, capsys):
    jm, v, port = detectors
    batches = [_batch(3), _batch(4)]
    kw = dict(lr=0.1, steps=6, log_every=5, verbose=True)
    sj, rj, hj = jfp.optimize_fixed_pipeline(
        JCFG, CHAIN, jm, v, ANCHORS, [_jax(b) for b in batches],
        hyp=JLossHyp(**HYP), **kw)
    st, rt, ht = tfp.optimize_fixed_pipeline(
        CFG, CHAIN, port, ANCHORS, [_port(b) for b in batches],
        hyp=LossHyp(**HYP), **kw)
    assert len(ht) == len(hj) == 6
    np.testing.assert_allclose(ht, hj, rtol=1e-4)
    assert ht[-1] != ht[0]
    for k, want in _np_raw(rj).items():
        np.testing.assert_allclose(rt[k].numpy(), want, rtol=0, atol=1e-4,
                                   err_msg=k)
    assert [n for n, _ in st] == [n for n, _ in sj] == list(CHAIN)
    for (_, a), (_, b) in zip(st, sj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-4)
    assert capsys.readouterr().out.count("[fixed-pipeline 0 lum]") == 2
