"""The port's training slice against the JAX package.

A narrow agent and critic (base_channels 8, 256 trunk features, fc1 32, the
full 10-filter roster with denoise, dropout off) and the 2-level mini
detector of ``tests/test_train_eval.py`` are initialised in JAX and carried
across with ``agent_from_flax`` / ``value_from_flax`` / ``yolo_from_flax``.
The same numpy batch (2 images of 64 px with exact 0 and 1 pixels; image 0
steered onto denoise) goes through both.  Held against JAX: the train-mode
forwards and their BatchNorm statistics, ``bbox_ciou`` and
``per_image_loss_batch``, the optimizer, and ``make_train_step``: gradients
(SGD at learning rate 1 on both sides, so old - new is the gradient), then
parameters, statistics and metrics after 1 and 3 clip + Adam steps.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from adaptiveisp_tpu.config import Config as JConfig
from adaptiveisp_tpu.config import TrainConfig as JTrainConfig
from adaptiveisp_tpu.detect import boxes as jboxes
from adaptiveisp_tpu.detect import loss as jloss
from adaptiveisp_tpu.detect.convert import convert_value_state_dict
from adaptiveisp_tpu.detect.model import DetectionModel as JDetectionModel
from adaptiveisp_tpu.policy.agent import Agent as JAgent
from adaptiveisp_tpu.policy.value import Value as JValue
from adaptiveisp_tpu.train import optim as joptim
from adaptiveisp_tpu.train.step import init_train_state as j_init
from adaptiveisp_tpu.train.step import make_train_step as j_make
from adaptiveisp_tpu.train.trainer import imgsz_hyp as j_imgsz_hyp
from adaptiveisp_tpu_torch.config import Config, TrainConfig
from adaptiveisp_tpu_torch.convert import (
    agent_from_flax,
    value_from_flax,
    yolo_from_flax,
)
from adaptiveisp_tpu_torch.detect import boxes as tboxes
from adaptiveisp_tpu_torch.detect import loss as tloss
from adaptiveisp_tpu_torch.detect.model import DetectionModel
from adaptiveisp_tpu_torch.policy.agent import Agent
from adaptiveisp_tpu_torch.policy.value import Value
from adaptiveisp_tpu_torch.train import optim as toptim
from adaptiveisp_tpu_torch import api
from adaptiveisp_tpu_torch.train.step import (
    init_train_state,
    make_input_loss_fn,
    make_train_step,
)
from adaptiveisp_tpu_torch.train.trainer import imgsz_hyp
from torch_suite import cheap_xla, one_torch_thread  # noqa: F401

# detect_loss_weight 0.3 keeps the random detector's loss (about 2.8)
# inside the reward's clip to [0, 1], so its gradient reaches the render
NARROW = dict(base_channels=8, feature_extractor_dims=256, fc1_size=32,
              dropout_keep_prob=1.0, detect_loss_weight=0.3)
CFG, JCFG = Config(**NARROW), JConfig(**NARROW)
IMG, BATCH, PROGRESS = 64, 2, 0.25
MINI_SPEC = {   # tests/test_train_eval.py's
    "nc": 8,
    "anchors": [[10, 14, 23, 27, 37, 58], [81, 82, 135, 169, 344, 319]],
    "backbone": [
        [-1, 1, "Conv", [8, 3, 2]],
        [-1, 1, "Conv", [16, 3, 2]],
        [-1, 1, "Conv", [16, 3, 2]],
        [-1, 1, "Bottleneck", [16]],
        [-1, 1, "Conv", [32, 3, 2]],
    ],
    "head": [
        [-1, 1, "Conv", [32, 3, 2]],
        [[4, 5], 1, "Detect", ["nc", "anchors"]],
    ],
}
ANCHORS = [np.asarray(MINI_SPEC["anchors"][0], np.float32).reshape(-1, 2) / 16,
           np.asarray(MINI_SPEC["anchors"][1], np.float32).reshape(-1, 2) / 32]
HYP = jloss.LossHyp()
DENOISE = CFG.filters.index("denoise")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _stats(variables, seed):
    """Non-trivial BatchNorm statistics, so their conversion and update
    are load-bearing."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
        variables["batch_stats"])


def _seeded_variables(module, args, seed, stats=True):
    """Seeded numpy flax variables over the shapes ``module.init`` declares
    (no compile): kernels normal with variance 1 / fan-in, BatchNorm
    scales in [0.5, 1.5], other parameters normal with scale 0.1; with
    ``stats`` non-trivial statistics (``_stats``), so their conversion and
    update are load-bearing, else init's (mean 0, variance 1)."""
    shapes = jax.eval_shape(lambda k: module.init(
        {"params": k, "dropout": k}, *args, train=False),
        jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['kernel']"):
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name.endswith("['scale']"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (rng.randn(*s.shape) * 0.1).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(fill, shapes["params"])
    if stats:
        return {"params": params, "batch_stats": _stats(shapes, seed + 1)}
    return {"params": params, "batch_stats": jax.tree_util.tree_map_with_path(
        lambda path, a: (np.zeros if jax.tree_util.keystr(path).endswith(
            "['mean']") else np.ones)(a.shape, np.float32),
        shapes["batch_stats"])}


def _make_nets():
    """JAX modules and seeded numpy variables, and the port's twins loaded
    from them."""
    jagent, jvalue = JAgent(cfg=JCFG), JValue(cfg=JCFG)
    jyolo = JDetectionModel(spec=MINI_SPEC)
    x = jnp.zeros((BATCH, IMG, IMG, 3), jnp.float32)
    z = jnp.zeros((BATCH, JCFG.z_dim), jnp.float32)
    s = jnp.zeros((BATCH, JCFG.num_state_dim), jnp.float32)
    av = _seeded_variables(jagent, (x, z, s, 0.0), 0)
    vv = _seeded_variables(jvalue, (x, s), 10)
    yv = _seeded_variables(jyolo, (x[:1],), 20, stats=False)
    agent, value, yolo = Agent(CFG), Value(CFG), DetectionModel(MINI_SPEC)
    agent.load_state_dict(agent_from_flax(av["params"], av["batch_stats"],
                                          CFG))
    value.load_state_dict(value_from_flax(vv["params"], vv["batch_stats"],
                                          CFG))
    yolo.load_state_dict(yolo_from_flax(yv["params"], yv["batch_stats"],
                                        MINI_SPEC))
    return (jagent, av), (jvalue, vv), (jyolo, yv), agent, value, yolo


def _make_batch(nets):
    """imgs with exact 0/1 pixels, z steering image 0 onto denoise and
    image 1 onto saturation_plus (midpoints of their cdf intervals, read
    from a train-mode forward of a copy of the port's agent), states, and
    padded targets with two boxes of image 0 on one cell and anchor."""
    rng = np.random.RandomState(5)
    imgs = rng.uniform(-0.1, 1.1, (BATCH, IMG, IMG, 3)).clip(0, 1)
    imgs = imgs.astype(np.float32)
    z = rng.rand(BATCH, CFG.z_dim).astype(np.float32)
    states = np.zeros((BATCH, CFG.num_state_dim), np.float32)
    states[1, 2] = 2.0
    states[1, 3 + 1] = states[1, 3 + 4] = 1.0
    probe = copy.deepcopy(nets[3]).train()
    with torch.no_grad():
        pdf = probe(torch.from_numpy(imgs), torch.from_numpy(z),
                    torch.from_numpy(states), PROGRESS,
                    train=True)[5]["pdf"].numpy()
    for i, k in enumerate((DENOISE, CFG.filters.index("saturation_plus"))):
        lo = pdf[i, :k].sum()
        z[i, 0] = lo + 0.5 * pdf[i, k]
    labels = [np.array([[2, 0.52, 0.5, 0.3, 0.4], [5, 0.53, 0.51, 0.32, 0.38],
                        [1, 0.2, 0.7, 0.1, 0.15]], np.float32),
              np.array([[0, 0.6, 0.3, 0.5, 0.25]], np.float32)]
    targets, tmask = tloss.pad_targets(labels, 4)
    return imgs, z, states, targets, tmask


@pytest.fixture(scope="module")
def nets():
    return _make_nets()


@pytest.fixture(scope="module")
def batch(nets):
    return _make_batch(nets)


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _close_tree(got_sd, want_sd, atol, what="", stats_atol=1e-4):
    """Parameters to atol, BatchNorm running statistics to stats_atol."""
    for k, want in want_sd.items():
        if k.endswith("num_batches_tracked"):
            continue
        tol = stats_atol if "running" in k else atol
        np.testing.assert_allclose(got_sd[k].detach().numpy(),
                                   want.numpy(), rtol=0, atol=tol,
                                   err_msg=f"{what} {k}")


def test_train_mode_forwards_match_flax(nets, batch):
    """Train mode, dropout off: outputs and the updated BatchNorm running
    statistics of both networks (conv trunks in another summation order:
    1e-4 on [0, 1] images and on statistics of O(1))."""
    (jagent, av), (jvalue, vv), _, agent, value, _ = nets
    imgs, z, states, _, _ = batch
    (out_j, st_j, sur_j, pen_j, _, info_j), amut = jax.jit(
        lambda v, x, zz, s: jagent.apply(v, x, zz, s, PROGRESS, train=True,
                                         mutable=["batch_stats"]))(
        av, *_j(imgs, z, states))
    (vout_j, vmut) = jax.jit(lambda v, x, s: jvalue.apply(
        v, x, s, train=True, mutable=["batch_stats"]))(vv, *_j(imgs, states))
    agent, value = copy.deepcopy(agent).train(), copy.deepcopy(value).train()
    with torch.no_grad():
        out_t, st_t, sur_t, pen_t, _, info_t = agent(*_t(imgs, z, states),
                                                     PROGRESS, train=True)
        vout_t = value(*_t(imgs, states))
    np.testing.assert_array_equal(info_t["selected_filter"].numpy(),
                                  [DENOISE, 7])
    np.testing.assert_array_equal(info_t["selected_filter"].numpy(),
                                  np.asarray(info_j["selected_filter"]))
    np.testing.assert_allclose(info_t["pdf"].numpy(),
                               np.asarray(info_j["pdf"]), atol=1e-5)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-4)
    np.testing.assert_array_equal(st_t.numpy(), np.asarray(st_j))
    np.testing.assert_allclose(sur_t.numpy(), np.asarray(sur_j), atol=1e-4)
    np.testing.assert_allclose(pen_t.numpy(), np.asarray(pen_j), atol=1e-4)
    np.testing.assert_allclose(vout_t.numpy(), np.asarray(vout_j),
                               rtol=1e-4, atol=1e-4)
    _close_tree(agent.state_dict(),
                agent_from_flax(av["params"], _np_tree(amut["batch_stats"]),
                                CFG), atol=1e-4, what="agent")
    _close_tree(value.state_dict(),
                value_from_flax(vv["params"], _np_tree(vmut["batch_stats"]),
                                CFG), atol=1e-4, what="value")


def test_bbox_ciou_values_and_grads_match_jax():
    rng = np.random.RandomState(6)
    b1 = np.concatenate([rng.rand(64, 2) * 4, rng.rand(64, 2) * 2 + 0.1], 1)
    b2 = np.concatenate([rng.rand(64, 2) * 4, rng.rand(64, 2) * 2 + 0.1], 1)
    b2[:4] = b1[:4]                      # identical boxes
    b2[4:8, 0] = b1[4:8, 0] + (b1[4:8, 2] + b2[4:8, 2]) / 2   # touching
    b1, b2 = b1.astype(np.float32), b2.astype(np.float32)
    want, gj = jax.value_and_grad(
        lambda a: jnp.sum(jboxes.bbox_ciou(a, jnp.asarray(b2)) ** 2))(
        jnp.asarray(b1))
    x = torch.from_numpy(b1).requires_grad_(True)
    got = torch.sum(tboxes.bbox_ciou(x, torch.from_numpy(b2)) ** 2)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gj), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("hyp", [{}, {"fl_gamma": 1.5,
                                     "label_smoothing": 0.1}],
                         ids=["default", "focal_smoothed"])
def test_per_image_loss_batch_matches_jax(batch, hyp):
    """Random logits at the mini detector's two levels; image 0 has two
    boxes on one cell and anchor (the max-scatter of objectness).  Values,
    components and the gradient to the logits, with the default hyp and
    with focal loss and label smoothing on."""
    _, _, _, targets, tmask = batch
    rng = np.random.RandomState(7)
    preds = [rng.randn(BATCH, s, s, 3, 13).astype(np.float32)
             for s in (4, 2)]
    hyp_j, hyp_t = jloss.LossHyp(**hyp), tloss.LossHyp(**hyp)

    def loss_j(ps):
        total, comps = jloss.per_image_loss_batch(
            ps, jnp.asarray(targets), jnp.asarray(tmask), ANCHORS, hyp_j)
        return jnp.sum(total * jnp.array([[1.0], [2.0]])), (total, comps)

    (_, (tot_j, comps_j)), g_j = jax.jit(
        jax.value_and_grad(loss_j, has_aux=True))([jnp.asarray(p)
                                                   for p in preds])
    ps = [torch.from_numpy(p).requires_grad_(True) for p in preds]
    tot_t, comps_t = tloss.per_image_loss_batch(
        ps, *_t(targets, tmask), ANCHORS, hyp_t)
    (tot_t * torch.tensor([[1.0], [2.0]])).sum().backward()
    np.testing.assert_allclose(tot_t.detach().numpy(), np.asarray(tot_j),
                               rtol=1e-5)
    for k in ("box", "obj", "cls"):
        np.testing.assert_allclose(comps_t[k].detach().numpy(),
                                   np.asarray(comps_j[k]), rtol=1e-5,
                                   atol=1e-7)
    for p, g in zip(ps, g_j):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(g), rtol=1e-4,
                                   atol=1e-7)
    one_t, _ = tloss.per_image_loss([p[0] for p in ps], *_t(targets[0],
                                                            tmask[0]),
                                    ANCHORS, hyp_t)
    np.testing.assert_allclose(one_t.item(), float(tot_j[0, 0]), rtol=1e-5)
    assert tloss.LossHyp() == tloss.LossHyp(**vars(HYP))
    assert imgsz_hyp(512, 8, 2) == tloss.LossHyp(**vars(j_imgsz_hyp(512, 8,
                                                                     2)))


@pytest.mark.parametrize("scale", [1.0, 1e-8], ids=["clipped", "unclipped"])
def test_optimizer_matches_optax(scale):
    """ClipAdam against ``make_optimizer`` over 3 steps on a tree whose
    gradient norm is above (clipped) and below (unclipped) 1e-5."""
    rng = np.random.RandomState(8)
    params = {"a": rng.randn(4, 3).astype(np.float32),
              "b": rng.randn(5).astype(np.float32)}
    grads = [{k: (rng.randn(*v.shape) * scale).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    tx = joptim.make_optimizer(3e-5, 10)
    pj = jax.tree_util.tree_map(jnp.asarray, params)
    opt = tx.init(pj)
    ts = {k: torch.from_numpy(v.copy()).requires_grad_(True)
          for k, v in params.items()}
    topt = toptim.make_optimizer(3e-5, 10)(list(ts.values()))
    for g in grads:
        upd, opt = tx.update(jax.tree_util.tree_map(jnp.asarray, g), opt, pj)
        pj = optax.apply_updates(pj, upd)
        for k in ts:
            ts[k].grad = torch.from_numpy(g[k])
        topt.step()
        for k in ts:
            # Adam's steps are about lr = 3e-5 each: 1e-3 of one step
            np.testing.assert_allclose(ts[k].detach().numpy(),
                                       np.asarray(pj[k]), rtol=0, atol=3e-8)
    assert toptim.exp_segment_schedule(3e-5, 10)(5) == pytest.approx(
        joptim.exp_segment_schedule(3e-5, 10)(5), rel=1e-12)


@pytest.fixture(scope="module")
def jax_step(nets):
    """JAX's ``make_train_step``, jitted once for the SGD and the Adam
    tests: its optimizer is SGD at learning rate 1 where the traced ``sgd``
    is set and ``make_optimizer(3e-5, 100)`` where not, and
    ``max_brightness`` is traced too.  At max_brightness -1 no image is
    truncated, so the q-value's factor (1 - truncated) is exactly 1 and the
    step computes what ``use_truncated=False`` computes.  Returns (step,
    the Adam transform that initialises its state)."""
    (jagent, _), (jvalue, _), (jyolo, _), *_ = nets
    adam = joptim.make_optimizer(3e-5, 100)

    def switched(sgd):
        def update(grads, opt, params=None):
            upd, opt = adam.update(grads, opt, params)
            return jax.tree_util.tree_map(
                lambda g, u: jnp.where(sgd, -g, u), grads, upd), opt
        return optax.GradientTransformation(adam.init, update)

    @jax.jit
    def step(state, yv, batch, key, progress, max_brightness, sgd):
        tcfg = JTrainConfig(batch_size=BATCH, max_brightness=max_brightness)
        tx = switched(sgd)
        return j_make(jagent, jvalue, jyolo, JCFG, tcfg, ANCHORS, HYP, tx,
                      tx)(state, yv, batch, key, progress)

    return step, adam


def _steps(nets, batch, jax_step, sgd, tx_t, n_steps, use_truncated=True):
    """Run both train steps n_steps times from the same weights on the same
    batch; yields (JAX output, port output) after each.  ``sgd``: SGD at
    learning rate 1 on both sides, else the Adam chain (JAX's) and ``tx_t``
    (the port's)."""
    (_, av), (_, vv), (_, yv), agent, value, yolo = nets
    step_j, adam = jax_step
    tcfg_t = TrainConfig(batch_size=BATCH, use_truncated=use_truncated)
    max_brightness = jnp.float32(tcfg_t.max_brightness if use_truncated
                                 else -1.0)
    state_j = j_init(av, vv, adam, adam)
    state_t = init_train_state(copy.deepcopy(agent), copy.deepcopy(value),
                               tx_t, tx_t)
    step_t = make_train_step(copy.deepcopy(yolo), CFG, tcfg_t, ANCHORS,
                             tloss.LossHyp())
    for _ in range(n_steps):
        out_j = step_j(state_j, yv, _j(*batch), jax.random.PRNGKey(9),
                       PROGRESS, max_brightness, jnp.asarray(sgd))
        out_t = step_t(state_t, _t(*batch), None, PROGRESS)
        state_j = out_j.state
        yield out_j, out_t


def _check_metrics(out_j, out_t, atol):
    m_j = {k: np.asarray(v) for k, v in out_j.metrics.items()}
    m_t = {k: v.numpy() for k, v in out_t.metrics.items()}
    assert m_t.keys() == m_j.keys()
    np.testing.assert_array_equal(m_t["selected_filter"],
                                  m_j["selected_filter"])
    assert m_t["retouch_finite"] and m_j["retouch_finite"]
    for k in m_j:
        if k not in ("selected_filter", "retouch_finite"):
            np.testing.assert_allclose(m_t[k], m_j[k], rtol=1e-4, atol=atol,
                                       err_msg=k)
    np.testing.assert_allclose(out_t.retouch.numpy(),
                               np.asarray(out_j.retouch), atol=1e-4)


def test_train_step_sgd_gradients_match_jax(nets, batch, jax_step):
    """SGD at learning rate 1 on both sides: old - new is each network's
    gradient.  No truncation, so the critic's value of the retouched image
    also reaches the render.  Metrics to 1e-4 and gradients to 1e-4 of the
    network's largest gradient: the reward is 100x a difference of two
    losses, so float32 noise of 1e-7 in a loss moves gradients by about
    1e-5 of their largest (measured 2.2e-5), and a conv bias before
    BatchNorm has gradient 0 up to such noise."""
    (_, av), (_, vv), _, agent, value, _ = nets
    out_j, out_t = next(_steps(nets, batch, jax_step, True,
                               lambda ps: torch.optim.SGD(ps, lr=1.0), 1,
                               use_truncated=False))
    _check_metrics(out_j, out_t, atol=1e-4)
    assert out_t.state.step == 1 and int(out_j.state.step) == 1
    for old_t, new_t, old_j, new_j in (
            (agent, out_t.state.agent,
             agent_from_flax(av["params"], av["batch_stats"], CFG),
             agent_from_flax(_np_tree(out_j.state.agent_params),
                             _np_tree(out_j.state.agent_stats), CFG)),
            (value, out_t.state.value,
             value_from_flax(vv["params"], vv["batch_stats"], CFG),
             value_from_flax(_np_tree(out_j.state.value_params),
                             _np_tree(out_j.state.value_stats), CFG))):
        sd_t, sd_new = old_t.state_dict(), new_t.state_dict()
        net_max = max(float((old_j[k] - new_j[k]).abs().max())
                      for k in old_j if "running" not in k
                      and not k.endswith("num_batches_tracked"))
        for k, p_old in sd_t.items():
            if k.endswith("num_batches_tracked"):
                continue
            if "running" in k:   # statistics: the updated values
                np.testing.assert_allclose(sd_new[k].numpy(),
                                           new_j[k].numpy(), atol=1e-4,
                                           err_msg=k)
                continue
            np.testing.assert_allclose(
                (p_old - sd_new[k]).numpy(), (old_j[k] - new_j[k]).numpy(),
                rtol=0, atol=1e-4 * net_max, err_msg=k)
    # image 0 took denoise: its strength head has a gradient
    assert float(np.abs((agent.state_dict()["NLM.fc_filter.weight"]
                         - out_t.state.agent.state_dict()
                         ["NLM.fc_filter.weight"]).numpy()).max()) > 0


def test_train_step_adam_matches_jax_after_1_and_3_steps(nets, batch,
                                                        jax_step):
    """The real chain (clip at 1e-5, Adam, lr 3e-5 decaying): parameters
    to 3e-7 (1 % of one Adam step), statistics to 1e-4 and metrics to
    1e-4 after steps 1 and 3."""
    tx_t = toptim.make_optimizer(3e-5, 100)
    for i, (out_j, out_t) in enumerate(_steps(nets, batch, jax_step, False,
                                              tx_t, 3)):
        if i == 1:
            continue
        _check_metrics(out_j, out_t, atol=1e-4)
        assert out_t.state.step == i + 1
        _close_tree(out_t.state.agent.state_dict(),
                    agent_from_flax(_np_tree(out_j.state.agent_params),
                                    _np_tree(out_j.state.agent_stats), CFG),
                    atol=3e-7, what=f"step {i + 1} agent")
        _close_tree(out_t.state.value.state_dict(),
                    value_from_flax(_np_tree(out_j.state.value_params),
                                    _np_tree(out_j.state.value_stats), CFG),
                    atol=3e-7, what=f"step {i + 1} value")


def test_cached_input_loss_step_equals_recomputed(nets, batch):
    """The cached-input-loss variant, fed ``make_input_loss_fn``'s loss,
    gives the recomputing step's metrics and parameters."""
    *_, agent, value, yolo = nets
    tx = toptim.make_optimizer(3e-5, 100)
    outs = []
    for cached in (False, True):
        state = init_train_state(copy.deepcopy(agent), copy.deepcopy(value),
                                 tx, tx)
        step = make_train_step(copy.deepcopy(yolo), CFG,
                               TrainConfig(batch_size=BATCH), ANCHORS,
                               tloss.LossHyp(), cached_input_loss=cached)
        b = _t(*batch)
        if cached:
            b += (make_input_loss_fn(copy.deepcopy(yolo), CFG, ANCHORS,
                                     tloss.LossHyp())(b[0], b[3], b[4]),)
        outs.append((step(state, b, None, PROGRESS), state))
    (o0, s0), (o1, s1) = outs
    for k in o0.metrics:
        torch.testing.assert_close(o1.metrics[k], o0.metrics[k], rtol=0,
                                   atol=0)
    for a, b in zip(s0.agent.parameters(), s1.agent.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_value_state_dict_gives_back_flax_tree():
    """Full width: ``value_from_flax`` and the JAX package's
    ``convert_value_state_dict`` invert each other; ``api.load_value``
    loads the result."""
    jvalue = JValue(cfg=JConfig())
    variables = _np_tree(jax.jit(lambda k: jvalue.init(
        {"params": k}, jnp.zeros((1, IMG, IMG, 3)),
        jnp.zeros((1, JConfig().num_state_dim)), train=False))(
        jax.random.PRNGKey(3)))
    stats = _stats(variables, 11)
    sd = value_from_flax(variables["params"], stats, Config())
    value = api.load_value(Config(), device="cpu", state_dict=sd)
    params, stats_back = convert_value_state_dict(
        {k: v.numpy() for k, v in value.state_dict().items()})
    want = jax.tree_util.tree_flatten_with_path(
        {"p": variables["params"], "s": stats})[0]
    got = {jax.tree_util.keystr(k): v for k, v in
           jax.tree_util.tree_flatten_with_path(
               {"p": params, "s": stats_back})[0]}
    assert len(got) == len(want)
    for k, v in want:
        np.testing.assert_array_equal(got[jax.tree_util.keystr(k)], v,
                                      err_msg=jax.tree_util.keystr(k))
