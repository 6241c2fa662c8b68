"""The port's data parallelism on the RL path against the JAX package's
``make_mesh(2)`` runs, on the CPU.

Two gloo ranks start once for the module (``torch_mesh_ranks.py``: spawned
ranks import it by name) and run every scenario on one torch thread each.
JAX's side is one ``Trainer(mesh=make_mesh(2), device_replay=True)`` on
conftest's virtual CPU devices (the reduced ``config_fast_filters`` roster,
dropout off, the 2-level mini detector in f32, 64 px, global batch 4, a
pool of 8 slots, 4 a shard); its sharded step (``shard_train_step``) also
serves the step check.  Held against JAX:
  * two DP train steps on a fixed batch: metrics to 1e-4 (JAX's own sharded
    test: value loss 1e-4 relative, reward 1e-3), parameters to 3e-7 (1 %
    of one Adam step), BatchNorm statistics to 1e-4;
  * ``Trainer(mesh=)`` for 3 iterations: the sampled slots (B/D from each
    shard's range) and their states exactly, ``history`` to 1e-4, each
    shard's pool images and cached losses to 1e-4, the state matrix
    exactly, parameters within the optimizer-noise bound of
    ``ROADMAP.md`` §3 (every element within 2 summed learning rates, all
    but 1 % of them within 1 % of it: an element whose gradient is float32
    noise moves by about lr either way; measured 0.1 % of the agent's
    elements up to 2.9 % of the summed lr apart), statistics to 1e-4;
  * ``run_validation(mesh=)`` (a last batch that does not divide runs
    whole): ``records`` and ``map50`` equal.
Then the port alone: a DP step with dropout on against the single-process
step at the global batch (masks drawn at the global shape), the ranks'
replicas bit for bit equal, ``train_isp --device cpu --dp 2`` through the
CLI, and the refusals (a rank's failure, a mesh of more ranks than the
process group, a card that is not there).
"""

import os
import re
import threading

import jax
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from adaptiveisp_tpu.config import TrainConfig as JTrainConfig
from adaptiveisp_tpu.data.datasets import ISPDataset as JISPDataset
from adaptiveisp_tpu.eval.validator import run_validation as jrun_validation
from adaptiveisp_tpu.train import mesh as jmesh
from adaptiveisp_tpu.train.trainer import Trainer as JTrainer
from adaptiveisp_tpu_torch import parallel, train_isp
from adaptiveisp_tpu_torch.config import TrainConfig
from adaptiveisp_tpu_torch.configs.config_fast_filters import cfg as FAST
from adaptiveisp_tpu_torch.convert import (
    agent_from_flax,
    value_from_flax,
    yolo_from_flax,
)
from adaptiveisp_tpu_torch.data.datasets import ISPDataset
from adaptiveisp_tpu_torch.detect.loss import pad_targets
from adaptiveisp_tpu_torch.detect.model import (
    DetectionModel,
    anchors_in_grid_units,
)
from adaptiveisp_tpu_torch.eval.validator import run_validation
from adaptiveisp_tpu_torch.policy.agent import Agent
from adaptiveisp_tpu_torch.policy.value import Value
from adaptiveisp_tpu_torch.train import mesh as mesh_lib
from adaptiveisp_tpu_torch.train.optim import (
    exp_segment_schedule,
    make_optimizer,
)
from adaptiveisp_tpu_torch.train.step import (
    init_train_state,
    make_train_step,
)
from adaptiveisp_tpu_torch.train.trainer import imgsz_hyp
from configs.config_fast_filters import cfg as JFAST
from test_torch_nlm import cheap_xla, one_torch_thread  # noqa: F401
from test_torch_trainer import _seeded_inits
import torch_mesh_ranks

KW = dict(replay_memory_size=8, val_freq=10 ** 9, save_model_freq=2,
          print_freq=1, summary_freq=1, dropout_keep_prob=1.0)
CFG, JCFG = FAST.replace(**KW), JFAST.replace(**KW)
TKW = dict(batch_size=4, epochs=1, imgsz=64, data_name="lod")
MINI_SPEC = {   # tests/test_trainer_validator.py's
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
TRAINER_KW = dict(yolo_spec=MINI_SPEC, t_max=8, log=False,
                  yolo_dtype="float32", device_replay=True,
                  cached_reward=True)
VAL_KW = dict(steps=2, batch_size=2, max_images=5)
PROGRESS, DROPOUT_SEED = 0.25, 3


def _toy_set(root, n=10, seed=33):
    rng = np.random.RandomState(seed)
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    for i in range(n):
        Image.fromarray((rng.rand(64, 64, 3) * 255).astype(np.uint8)).save(
            root / "images" / f"{i}.png")
        k = 1 + i % 3
        rows = np.concatenate([rng.randint(0, 8, (k, 1)),
                               rng.uniform(0.3, 0.7, (k, 2)),
                               rng.uniform(0.1, 0.4, (k, 2))], 1)
        (root / "labels" / f"{i}.txt").write_text(
            "".join(" ".join(f"{v:.6f}" for v in r) + "\n" for r in rows))
    return str(root / "images")


def _step_batch():
    """4 images (2 a rank) whose ranks hold 1 + 2 and 3 + 4 targets."""
    rng = np.random.RandomState(5)
    imgs = rng.rand(4, 64, 64, 3).astype(np.float32)
    z = rng.rand(4, CFG.z_dim).astype(np.float32)
    states = np.zeros((4, CFG.num_state_dim), np.float32)
    states[1, 2] = 2.0
    labels = [np.concatenate([rng.randint(0, 8, (k, 1)),
                              rng.uniform(0.3, 0.7, (k, 2)),
                              rng.uniform(0.1, 0.4, (k, 2))], 1)
              .astype(np.float32) for k in (1, 2, 3, 4)]
    targets, tmask = pad_targets(labels, 8)
    loss_in = rng.uniform(0.2, 0.8, (4, 1)).astype(np.float32)
    return [imgs, z, states, targets, tmask, loss_in]


def _record_samples(pool):
    seen, sample = [], pool.sample

    def recorded(n):
        out = sample(n)
        seen.append((np.array(out[0]), np.array(out[2])))
        return out

    pool.sample = recorded
    return seen


def _in_thread(fn):
    """Run fn() in a thread (it waits on rank processes); returns a
    function that joins it and gives (result, exception)."""
    box = {}

    def run():
        try:
            box["result"] = fn()
        except BaseException as e:  # noqa: B036 (handed to the test)
            box["error"] = e

    t = threading.Thread(target=run)
    t.start()

    def join():
        t.join()
        return box.get("result"), box.get("error")

    return join


def _cli_args(tmp):
    """``train_isp --device cpu --dp 2`` for one iteration on a toy set.
    On the ranks' path: no TensorFlow for the metric writer (its import
    takes 10 s), the fast roster with a pool of 8 slots, the mini
    detector."""
    _toy_set(tmp / "toy")
    (tmp / "toy.yaml").write_text(yaml.safe_dump({
        "path": str(tmp / "toy"), "train": "images", "val": "images",
        "nc": 80, "source": "normalize"}))
    stub = tmp / "stub"
    (stub / "tensorflow").mkdir(parents=True)
    (stub / "tensorflow" / "__init__.py").write_text(
        "raise ImportError('not in this test')\n")
    (stub / "mesh_cli_cfg.py").write_text(
        "from adaptiveisp_tpu_torch.configs.config_fast_filters import cfg"
        " as fast\ncfg = fast.replace(replay_memory_size=8)\n")
    (tmp / "mini.yaml").write_text(yaml.safe_dump(MINI_SPEC))
    return str(stub), [
        "--data_cfg", str(tmp / "toy.yaml"), "--device", "cpu", "--dp", "2",
        "--imgsz", "64", "--batch_size", "4", "--yolo_spec",
        str(tmp / "mini.yaml"), "--weights", "missing.pt", "--task", "train",
        "--max_steps", "0", "--cfg", "mesh_cli_cfg"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's mesh trainer (3 iterations), its sharded step twice on the
    fixed batch and its validation over the mesh; the port's two ranks.
    The ranks, the CLI's own two ranks and a failing launch run while JAX
    computes."""
    root = tmp_path_factory.mktemp("mesh")
    mesh = jmesh.make_mesh(2)
    monkeypatch = pytest.MonkeyPatch()
    stub, cli_args = _cli_args(root / "cli")
    monkeypatch.syspath_prepend(stub)
    # the CLI writes experiments/ under its working directory (everything
    # else here takes absolute paths)
    monkeypatch.chdir(root / "cli")
    cli = _in_thread(lambda: train_isp.main(cli_args))
    failing = _in_thread(
        lambda: torch_mesh_ranks.launch(root / "fail", "failing")())
    _seeded_inits(monkeypatch)
    try:
        jtr = JTrainer(JCFG, JTrainConfig(**TKW), _toy_set(root / "jax"),
                       save_dir=str(root / "jexp"), mesh=mesh, **TRAINER_KW)
        s0 = jax.device_get(jtr.state)
        yv = jax.device_get(jtr.yolo_vars)
        weights = dict(
            agent_state_dict=agent_from_flax(s0.agent_params,
                                             s0.agent_stats, CFG),
            value_state_dict=value_from_flax(s0.value_params,
                                             s0.value_stats, CFG),
            yolo_state_dict=yolo_from_flax(yv["params"], yv["batch_stats"],
                                           MINI_SPEC))
        batch = _step_batch()
        data_t = _toy_set(root / "port")
        torch.save(dict(cfg=KW, tcfg=TKW, weights=weights, spec=MINI_SPEC,
                        step_batch=batch, progress=PROGRESS,
                        dropout_seed=DROPOUT_SEED, data=data_t, max_steps=2,
                        trainer_kw=TRAINER_KW, val_kw=VAL_KW),
                   root / "inputs.pt")
        ranks = torch_mesh_ranks.launch(root, "rl_scenarios")

        state, jsteps = jmesh.replicate(mesh, s0), []
        for _ in range(2):
            out = jtr.train_step(state, jtr.yolo_vars,
                                 jmesh.shard_batch(mesh, tuple(batch)),
                                 jax.random.PRNGKey(9), PROGRESS)
            state = out.state
            jsteps.append({k: np.asarray(v) for k, v in
                           jax.device_get(out.metrics).items()})
        jstep_state = jax.device_get(state)
        jval = jrun_validation(
            JCFG, jtr.agent, {"params": s0.agent_params,
                              "batch_stats": s0.agent_stats},
            jtr.yolo, yv, JISPDataset(str(root / "jax" / "images"),
                                      img_size=64, source="normalize",
                                      train=False, cache_labels=False),
            yolo_spec=MINI_SPEC, mesh=mesh, **VAL_KW)
        seen_j = _record_samples(jtr.device_replay)
        jtr.train(max_steps=2)
        yield dict(jtr=jtr, jsteps=jsteps, jstep_state=jstep_state,
                   jval=jval, seen_j=seen_j, ranks=ranks(), weights=weights,
                   batch=batch, data_t=data_t, root=root, cli=cli(),
                   cli_run=root / "cli" / "experiments" / "lod-adaptiveisp",
                   failing=failing())
    finally:
        cli(), failing()
        monkeypatch.undo()
        if "jtr" in locals():
            jtr.close()


def _close_sd(got, want, atol, stats_atol=1e-4, what=""):
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(
            got[k].numpy(), w.numpy(), rtol=0,
            atol=stats_atol if "running" in k else atol,
            err_msg=f"{what} {k}")


def _close_metrics(got, want):
    for k in ("agent_loss", "value_loss", "detect_input_loss",
              "detect_retouch_loss", "reward", "penalty", "q_value",
              "retouch_mean", "loss_components"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    np.testing.assert_array_equal(got["selected_filter"].numpy(),
                                  want["selected_filter"])
    np.testing.assert_allclose(got["retouch_loss_per_image"].numpy(),
                               want["retouch_loss_per_image"], atol=1e-4)
    assert bool(got["retouch_finite"]) and bool(want["retouch_finite"])


def test_dp_train_step_matches_jax_sharded_step(runs):
    """Two steps of both ranks against JAX's ``shard_train_step`` over
    ``make_mesh(2)``: global metrics and gathered per-image outputs on
    both ranks, then the updated networks."""
    for rank in runs["ranks"]:
        got = rank["step"]
        for g, w in zip(got["runs"], runs["jsteps"]):
            _close_metrics(g["metrics"], w)
        js = runs["jstep_state"]
        _close_sd(got["agent"], agent_from_flax(js.agent_params,
                                                js.agent_stats, CFG), 3e-7,
                  what="agent")
        _close_sd(got["value"], value_from_flax(js.value_params,
                                                js.value_stats, CFG), 3e-7,
                  what="value")


def _single_step(weights, batch, cfg, generator_seed):
    """One step of the port's single-process step at the global batch."""
    tcfg = TrainConfig(**TKW)
    agent, value = Agent(cfg), Value(cfg)
    agent.load_state_dict(weights["agent_state_dict"])
    value.load_state_dict(weights["value_state_dict"])
    yolo = DetectionModel(MINI_SPEC)
    yolo.load_state_dict(weights["yolo_state_dict"])
    state = init_train_state(
        agent, value, make_optimizer(tcfg.lr, tcfg.max_iter_step),
        make_optimizer(tcfg.lr * cfg.value_lr_mul, tcfg.max_iter_step))
    step = make_train_step(yolo, cfg, tcfg, anchors_in_grid_units(MINI_SPEC),
                           imgsz_hyp(64, nc=8, nl=2), cached_input_loss=True)
    gen = torch.Generator().manual_seed(generator_seed)
    out = step(state, tuple(torch.from_numpy(a) for a in batch), gen,
               PROGRESS)
    return out, state


def test_dp_dropout_step_equals_single_process_and_replicas_agree(runs):
    """Dropout on (keep 0.5, the config's default) and BatchNorm in train
    mode: the two ranks' step equals the single-process step at the global
    batch from one generator seed (masks drawn at the global shape, rows
    kept per rank), metrics to 1e-5 relative and parameters to 3e-7; the
    ranks' networks are equal bit for bit after every scenario."""
    out, state = _single_step(runs["weights"], runs["batch"],
                              CFG.replace(dropout_keep_prob=0.5),
                              DROPOUT_SEED)
    r0, r1 = runs["ranks"]
    m = r0["dropout_step"]["runs"][0]["metrics"]
    for k in ("agent_loss", "value_loss", "reward", "q_value",
              "retouch_mean"):
        np.testing.assert_allclose(m[k].numpy(), out.metrics[k].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    assert torch.equal(m["selected_filter"], out.metrics["selected_filter"])
    _close_sd(r0["dropout_step"]["agent"], state.agent.state_dict(), 3e-7,
              stats_atol=1e-5, what="agent")
    _close_sd(r0["dropout_step"]["value"], state.value.state_dict(), 3e-7,
              stats_atol=1e-5, what="value")
    # each rank's retouch rows are the single-process step's
    for r, rank in enumerate((r0, r1)):
        np.testing.assert_allclose(
            rank["dropout_step"]["runs"][0]["retouch"].numpy(),
            out.retouch[2 * r:2 * r + 2].numpy(), atol=1e-5)
    for part in ("step", "dropout_step", "trainer"):
        for net in ("agent", "value"):
            for k, v in r0[part][net].items():
                assert torch.equal(v, r1[part][net][k]), (part, net, k)


def _update_errs(got, want, lr_sum):
    """After Adam steps each element moves by about lr a step whatever its
    gradient's size, so one whose gradient is float32 noise may move
    differently (``ROADMAP.md`` §3): the largest difference over the
    summed lr, and the share of elements more than 1 % of it apart."""
    worst, beyond, total = 0.0, 0, 0
    for k, w in want.items():
        if "num_batches" in k or "running" in k:
            continue
        d = (got[k] - w).abs() / lr_sum
        worst = max(worst, float(d.max()))
        beyond, total = beyond + int((d > 0.01).sum()), total + d.numel()
    return worst, beyond / total


def test_dp_trainer_matches_jax_mesh_trainer(runs):
    """Three iterations of ``Trainer(mesh=)`` on both ranks against JAX's
    mesh trainer: the per-shard sampled slots, pool shards, metadata,
    history and networks."""
    jtr, (r0, r1) = runs["jtr"], runs["ranks"]
    for rank in (r0, r1):
        t = rank["trainer"]
        assert len(t["seen"]) == len(runs["seen_j"]) == 3
        for (it, st), (ij, sj) in zip(t["seen"], runs["seen_j"]):
            np.testing.assert_array_equal(it, ij)
            np.testing.assert_array_equal(st, sj)
            # batch rows [2r, 2r + 2) come from shard r's slots
            assert (it[:2] < 4).all() and (it[2:] >= 4).all()
        assert t["step"] == int(jax.device_get(jtr.state.step)) == 3
        assert t["divergence_count"] == jtr.divergence_count
        for ht, hj in zip(t["history"], jtr.history):
            for k in hj:
                np.testing.assert_allclose(ht[k], hj[k], rtol=0, atol=1e-4,
                                           err_msg=k)
        np.testing.assert_array_equal(t["states"], jtr.device_replay.states)
        assert t["paths"] == [os.path.basename(m["path"])
                              for m in jtr.device_replay.meta]
        sj = jax.device_get(jtr.state)
        tcfg = TrainConfig(**TKW)
        for got, want, lr in (
                (t["agent"], agent_from_flax(sj.agent_params,
                                             sj.agent_stats, CFG), tcfg.lr),
                (t["value"], value_from_flax(sj.value_params,
                                             sj.value_stats, CFG),
                 tcfg.lr * CFG.value_lr_mul)):
            sched = exp_segment_schedule(lr, tcfg.max_iter_step)
            lr_sum = sum(sched(i) for i in range(3))
            worst, share = _update_errs(got, want, lr_sum)
            assert worst < 2.0 and share < 0.01, (worst, share)
            for k, w in want.items():
                if "running" in k:
                    np.testing.assert_allclose(got[k].numpy(), w.numpy(),
                                               rtol=0, atol=1e-4, err_msg=k)
    assert r0["trainer"]["states"][:, 2].max() > 0   # written back
    images = torch.cat([r0["trainer"]["images"], r1["trainer"]["images"]])
    losses = torch.cat([r0["trainer"]["loss_in"], r1["trainer"]["loss_in"]])
    np.testing.assert_allclose(images.numpy(),
                               np.asarray(jtr.device_replay.images),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(losses.numpy(),
                               np.asarray(jtr.device_replay.loss_in),
                               rtol=0, atol=1e-4)
    # rank 0 wrote the step-2 checkpoint, both saw it after the barrier
    assert r0["trainer"]["ckpts"] == r1["trainer"]["ckpts"] == [
        "2", "weights_iter_2.pt"]


def test_dp_host_pool_trainer_equals_single_process(runs, tmp_path):
    """The host pool (``device_replay=False``) over the mesh: each rank
    gathers the whole retouched batch and writes it back into its copy of
    the pool, so after two iterations every rank's pool and history equal
    the single-process trainer's at the global batch (history to 1e-5
    relative; images to 1e-4, as the device pools: the second iteration
    renders with parameters an Adam step apart in noise elements,
    measured 1.9e-5)."""
    inp = torch.load(runs["root"] / "inputs.pt", weights_only=False)
    want = torch_mesh_ranks._host_pool_run(CFG, inp, str(tmp_path))
    for rank in runs["ranks"]:
        got = rank["host_pool"]
        assert len(got["history"]) == len(want["history"]) == 2
        for hg, hw in zip(got["history"], want["history"]):
            for k in hw:
                np.testing.assert_allclose(hg[k], hw[k], rtol=1e-5,
                                           atol=1e-7, err_msg=k)
        assert [p for p, _, _ in got["pool"]] == [p for p, _, _ in
                                                  want["pool"]]
        for (_, ig, sg), (_, iw, sw) in zip(got["pool"], want["pool"]):
            np.testing.assert_allclose(ig, iw, rtol=0, atol=1e-4)
            np.testing.assert_array_equal(sg, sw)


def test_dp_validation_matches_jax_and_one_process(runs):
    """``run_validation(mesh=)`` on both ranks: records and mAP equal to
    JAX's mesh run and to the port's single-process run."""
    agent = Agent(CFG)
    agent.load_state_dict(runs["weights"]["agent_state_dict"])
    yolo = DetectionModel(MINI_SPEC)
    yolo.load_state_dict(runs["weights"]["yolo_state_dict"])
    one = run_validation(CFG, agent.eval(), yolo.eval(),
                         ISPDataset(runs["data_t"], img_size=64,
                                    source="normalize", train=False),
                         yolo_spec=MINI_SPEC, **VAL_KW)
    assert len(one["records"]) == VAL_KW["max_images"]
    for rank in runs["ranks"]:
        v = rank["validation"]
        assert v["records"] == runs["jval"]["records"] == one["records"]
        assert v["map50"] == one["map50"]
        assert v["map"] == one["map"]
        assert abs(v["map50"] - runs["jval"]["map50"]) < 1e-6


def test_train_isp_cli_dp2_on_cpu(runs):
    """``train_isp --device cpu --dp 2`` for one iteration: the CLI starts
    two gloo ranks itself (and returns None); rank 0 writes the metric
    log."""
    result, error = runs["cli"]
    assert error is None and result is None
    rows = [yaml.safe_load(ln) for ln in open(
        runs["cli_run"] / "logs" / "metrics.jsonl").read().splitlines()]
    assert {r["tag"] for r in rows} >= {"agent_loss", "reward"}
    assert all(r["step"] == 0 and np.isfinite(r["value"]) for r in rows)


def test_refusals_and_failures(runs):
    """A rank that fails fails the launch; a multi-rank mesh needs a
    started group; --dp below 0 needs cards; a card that is not there is
    never replaced by the CPU."""
    _, error = runs["failing"]
    assert isinstance(error, RuntimeError)
    assert re.search(r"rank\(s\) \[1\] failed .* others were stopped",
                     str(error))
    with pytest.raises(ValueError, match="launch or torchrun"):
        mesh_lib.make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="every card"):
        mesh_lib.resolve_ranks(-1, "cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh_lib.launch("os:getcwd", 2, device="cuda")


def test_card_check_counts_this_nodes_ranks(monkeypatch):
    """torchrun over two nodes of 8 cards (world 16): ``make_mesh`` checks
    this node's ranks (LOCAL_WORLD_SIZE, else LOCAL_RANK + 1) against its
    cards, not the world, and joins the group of 16; a node asked for
    more ranks than it has cards raises before it joins."""
    joined = []

    class Joined(Exception):
        pass

    def join(backend, world, rank, init_method):
        joined.append((backend, world, rank, init_method))
        raise Joined

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.setattr(parallel, "_init_group", join)
    monkeypatch.setattr(parallel.dist, "is_initialized", lambda: False)
    for k, v in dict(WORLD_SIZE="16", RANK="9", LOCAL_RANK="1",
                     LOCAL_WORLD_SIZE="8").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(Joined):
        parallel.make_mesh(device="cuda")
    assert joined == [("nccl", 16, 9, "env://")]
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "9")
    with pytest.raises(ValueError, match="9 cards; 8 visible"):
        parallel.make_mesh(device="cuda")
    monkeypatch.delenv("LOCAL_WORLD_SIZE")
    assert parallel.node_ranks(16) == 2
    monkeypatch.delenv("LOCAL_RANK")
    assert parallel.node_ranks(16) == 16
    with pytest.raises(ValueError, match="16 cards; 8 visible"):
        parallel.make_mesh(device="cuda")
    assert len(joined) == 1
