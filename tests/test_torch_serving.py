"""The composed serving slice against the JAX package: 5-step blend rollout
(``jit_rollout``) -> YOLOv3-tiny -> decode -> NMS in JAX, against the port's
``api`` path (``load_adaptive_isp(...).process_with_trace`` then
``load_detector(...).detect``) on the CPU, with the same flax weights and the
same numpy noise: 2 images at 64 px, one forced pipeline that starts with
``denoise`` and one free run.  Then the composed mAP gate: each chain's
detections scored by its own package's ``process_batch`` and ``summarize``
against the same labels.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from adaptiveisp_tpu.config import Config as JConfig
from adaptiveisp_tpu.detect.model import DetectionModel as JDetectionModel
from adaptiveisp_tpu.detect.model import decode_predictions as jdecode
from adaptiveisp_tpu.detect import metrics as jmetrics
from adaptiveisp_tpu.detect.nms import non_max_suppression as jnms
from adaptiveisp_tpu.eval.rollout import jit_rollout
from adaptiveisp_tpu.policy.agent import Agent as JAgent
from adaptiveisp_tpu.policy.states import get_initial_states, get_noise
from adaptiveisp_tpu_torch import api
from adaptiveisp_tpu_torch.config import Config
from adaptiveisp_tpu_torch.convert import agent_from_flax, yolo_from_flax
from adaptiveisp_tpu_torch.detect import metrics as tmetrics
from adaptiveisp_tpu_torch.detect.spec import YOLOV3_TINY_SPEC
from adaptiveisp_tpu_torch.eval.rollout import rollout
from adaptiveisp_tpu_torch.policy.states import STATE_STEP_DIM
from torch_suite import cheap_xla, one_torch_thread  # noqa: F401

CFG, JCFG = Config(), JConfig()
STEPS, SEED = 5, 21
NMS = dict(conf_thres=0.25, iou_thres=0.45, max_det=100)


def _seeded_variables(module, args, seed):
    """Seeded numpy flax variables over the shapes ``module.init`` declares."""
    shapes = jax.eval_shape(lambda k: module.init(
        {"params": k, "dropout": k}, *args, train=False),
        jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['kernel']"):
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name.endswith("['scale']") or name.endswith("['var']"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (rng.randn(*s.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def chains():
    jagent = JAgent(cfg=JCFG)
    av = _seeded_variables(jagent, (jnp.zeros((1, 64, 64, 3)),
                                    jnp.zeros((1, JCFG.z_dim)),
                                    jnp.zeros((1, JCFG.num_state_dim)), 0.0),
                           31)
    jyolo = JDetectionModel(spec=YOLOV3_TINY_SPEC)
    yv = _seeded_variables(jyolo, (jnp.zeros((1, 64, 64, 3)),), 32)
    roll = jit_rollout(jagent, STEPS, record_steps=True)

    @jax.jit
    def detect(v, x):
        return jnms(jdecode(jyolo.apply(v, x, train=False), YOLOV3_TINY_SPEC),
                    **NMS)

    isp = api.load_adaptive_isp(cfg=CFG, steps=STEPS, device="cpu",
                                state_dict=agent_from_flax(
                                    av["params"], av["batch_stats"], CFG))
    det = api.load_detector(spec=YOLOV3_TINY_SPEC, device="cpu",
                            state_dict=yolo_from_flax(
                                yv["params"], yv["batch_stats"],
                                YOLOV3_TINY_SPEC))
    return (roll, av, detect, yv), (isp, det), jagent


@pytest.mark.parametrize("pipeline", [[4, -1, 2, -1, -1], None],
                         ids=["forced_denoise", "free"])
def test_serving_chain_matches_jax(chains, pipeline):
    (roll, av, jdetect, yv), (isp, det), _ = chains
    images = np.random.RandomState(SEED).uniform(
        0.02, 0.98, (2, 64, 64, 3)).astype(np.float32)
    rng = np.random.RandomState(SEED)  # the noise stream process() draws
    noises = np.stack([get_noise(rng, 2, JCFG.z_dim) for _ in range(STEPS)])
    pipe = [-1] * STEPS if pipeline is None else pipeline
    res_j = roll(av, jnp.asarray(images), jnp.asarray(noises),
                 jnp.asarray(get_initial_states(2, JCFG.num_state_dim)),
                 jnp.asarray(pipe, jnp.int32))
    res_t = isp.process_with_trace(images, pipeline=pipeline, seed=SEED)

    np.testing.assert_array_equal(res_t.selected.numpy(),
                                  np.asarray(res_j.selected))
    if pipeline is not None:
        assert (res_t.selected[0] == 4).all()
    # float32 trunks and filters in another order: 1e-4 on [0, 1] pixels
    np.testing.assert_allclose(res_t.images_per_step.numpy(),
                               np.asarray(res_j.images_per_step), atol=1e-4)
    np.testing.assert_allclose(res_t.pdfs.numpy(), np.asarray(res_j.pdfs),
                               atol=1e-5)
    np.testing.assert_array_equal(res_t.states.numpy(),
                                  np.asarray(res_j.states))

    det_j, n_j = jdetect(yv, res_j.image)
    det_t, n_t = det.detect(res_t.image, **NMS)
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
    assert int(n_t.min()) > 0
    det_j = np.asarray(det_j)
    # boxes in pixels of a 64 px image, after a 13-layer detector
    np.testing.assert_allclose(det_t[..., :4].numpy(), det_j[..., :4],
                               atol=1e-3)
    np.testing.assert_allclose(det_t[..., 4].numpy(), det_j[..., 4],
                               atol=1e-4)
    np.testing.assert_array_equal(det_t[..., 5].numpy(), det_j[..., 5])


_JAX_ROLLOUTS = {}


def _early_exit_against_jax(chains, first_stopped):
    """``STEPS + 1`` steps of the port's rollout and JAX's on the same
    inputs; with ``first_stopped`` the first sample starts at its last
    step.  Returns the port's result."""
    (_, av, _, _), (isp, _), jagent = chains
    steps = STEPS + 1
    images = np.random.RandomState(SEED + 1).uniform(
        0.02, 0.98, (2, 64, 64, 3)).astype(np.float32)
    noises = np.random.RandomState(SEED + 2).rand(
        steps, 2, JCFG.z_dim).astype(np.float32)
    states = get_initial_states(2, JCFG.num_state_dim)
    if first_stopped:
        states[0, STATE_STEP_DIM] = JCFG.test_steps - 1
    if steps not in _JAX_ROLLOUTS:   # one compile for both tests
        _JAX_ROLLOUTS[steps] = jit_rollout(jagent, steps)
    res_j = _JAX_ROLLOUTS[steps](
        av, jnp.asarray(images), jnp.asarray(noises), jnp.asarray(states),
        jnp.full((steps,), -1, jnp.int32))
    res_t = rollout(isp.agent, torch.from_numpy(images),
                    torch.from_numpy(noises), torch.from_numpy(states),
                    [-1] * steps)
    np.testing.assert_array_equal(res_t.selected.numpy(),
                                  np.asarray(res_j.selected))
    assert (res_t.selected[-1] == -1).all()
    assert not res_t.pdfs[-1].any() and not res_t.params[-1].any()
    np.testing.assert_allclose(res_t.pdfs.numpy(), np.asarray(res_j.pdfs),
                               atol=1e-5)
    np.testing.assert_allclose(res_t.params.numpy(), np.asarray(res_j.params),
                               atol=1e-4)
    np.testing.assert_allclose(res_t.image.numpy(), np.asarray(res_j.image),
                               atol=1e-4)
    np.testing.assert_array_equal(res_t.states.numpy(),
                                  np.asarray(res_j.states))
    return res_t


def test_rollout_early_exit_matches_jax(chains):
    """One step past ``test_steps``: every sample has stopped, so the last
    step gives selection -1, zero pdf and params while image and state stay
    frozen, as in JAX's early-exit scan; the port decides it on the
    device."""
    _early_exit_against_jax(chains, first_stopped=False)


def test_rollout_partial_stop_matches_jax(chains):
    """The first sample starts at its last step, so it stops after step 0
    while the other runs on: the stop masks freeze it (selection -1) and
    zero nothing, until every sample has stopped at the last step."""
    res = _early_exit_against_jax(chains, first_stopped=True)
    assert (res.selected[1:, 0] == -1).all()
    assert (res.selected[:-1, 1] >= 0).all()
    assert res.pdfs[1:-1, 0].any()


def test_composed_rollout_detection_map_parity(chains):
    """The port's counterpart of
    ``tests/test_e2e_rollout_oracle.py::test_composed_rollout_detection_map_parity``:
    JAX rollout -> detector -> NMS (conf 0.001, IoU 0.6, multi-label, as
    validation runs it) -> JAX ``summarize`` against the port's chain ->
    port ``summarize``, 4 free-run images.  Labels are JAX's top 4
    detections of each image, jittered by up to 1.5 px, so mAP sits well
    above 0 and drift between the chains shows: |dmAP50|, |dmAP| < 0.01."""
    (roll, av, _, yv), (isp, det), _ = chains
    jyolo = JDetectionModel(spec=YOLOV3_TINY_SPEC)
    nms = dict(conf_thres=0.001, iou_thres=0.6, max_det=300,
               multi_label=True)
    jdetect = jax.jit(lambda v, x: jnms(jdecode(
        jyolo.apply(v, x, train=False), YOLOV3_TINY_SPEC), **nms))
    n, seed = 4, SEED + 7
    images = np.random.RandomState(seed).uniform(
        0.02, 0.98, (n, 64, 64, 3)).astype(np.float32)
    rng = np.random.RandomState(seed)
    noises = np.stack([get_noise(rng, n, JCFG.z_dim) for _ in range(STEPS)])
    res_j = roll(av, jnp.asarray(images), jnp.asarray(noises),
                 jnp.asarray(get_initial_states(n, JCFG.num_state_dim)),
                 jnp.full((STEPS,), -1, jnp.int32))
    res_t = isp.process_with_trace(images, seed=seed, record_steps=False)
    np.testing.assert_array_equal(res_t.selected.numpy(),
                                  np.asarray(res_j.selected))
    det_j, n_j = (np.asarray(a) for a in jdetect(yv, res_j.image))
    det_t, n_t = (a.numpy() for a in det.detect(res_t.image, **nms))
    iouv = np.linspace(0.5, 0.95, 10)
    jitter = np.random.RandomState(seed + 1)
    stats_j, stats_t = [], []
    for b in range(n):
        d_j, d_t = det_j[b, :n_j[b]], det_t[b, :n_t[b]]
        top = d_j[np.argsort(-d_j[:, 4], kind="stable")[:4]]
        labels = np.concatenate(
            [top[:, 5:6], top[:, :4] + jitter.uniform(-1.5, 1.5, (4, 4))],
            1)
        stats_j.append((jmetrics.process_batch(d_j, labels, iouv),
                        d_j[:, 4], d_j[:, 5], labels[:, 0]))
        stats_t.append((tmetrics.process_batch(d_t, labels, iouv),
                        d_t[:, 4], d_t[:, 5], labels[:, 0]))
    m_j, m_t = jmetrics.summarize(stats_j), tmetrics.summarize(stats_t)
    assert m_j["map50"] > 0.3, "JAX mAP degenerate; the gate would be vacuous"
    assert abs(m_t["map50"] - m_j["map50"]) < 0.01, (m_j, m_t)
    assert abs(m_t["map"] - m_j["map"]) < 0.01, (m_j, m_t)
