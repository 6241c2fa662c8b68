"""What each rank of the port's two-rank data mesh runs for
``tests/test_torch_mesh.py`` and ``tests/test_torch_mesh_detect.py``.

Spawned ranks import this module by name (a test file's functions would
re-import the test module, and with it JAX), so it imports only the port,
torch and numpy.  ``launch`` starts two gloo ranks on the CPU; each reads
``inputs.pt`` from the directory it is given, runs every scenario on one
torch thread and writes ``rank<r>.pt`` there.
"""

import os

import numpy as np
import torch

from adaptiveisp_tpu_torch.train import mesh as mesh_lib


# the ranks' scenarios take 1-2 min on a loaded host; ranks whose
# collectives fall out of step would otherwise wait out the group timeout
RANKS_TIMEOUT = 600


def launch(root, target: str):
    """Start two gloo ranks on the CPU running ``target`` (a function of
    this module) on ``root``; returns a function that waits for them
    (stopping them after RANKS_TIMEOUT s) and returns their outputs,
    rank 0's first."""
    ranks = mesh_lib.launch(f"{__name__}:{target}", 2, str(root),
                            device="cpu")

    def outputs():
        ranks.wait(timeout=RANKS_TIMEOUT)
        return [torch.load(os.path.join(root, f"rank{r}.pt"),
                           weights_only=False) for r in range(2)]

    return outputs


def _setup(root):
    torch.set_num_threads(1)
    mesh = mesh_lib.make_mesh(2, device="cpu")
    return mesh, torch.load(os.path.join(root, "inputs.pt"),
                            weights_only=False)


def _sd(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def _metrics(out):
    return {k: v.detach().clone() for k, v in out.metrics.items()}


# --------------------------------------------------------------------- #
# the RL path
# --------------------------------------------------------------------- #
def _rl_step_runs(mesh, inp, cfg, n_steps, generator_seed=None):
    """The DP train step from the given weights on the rank's rows of the
    fixed batch, ``n_steps`` times; (metrics and new states after each,
    the rank's retouch rows, both networks' state dicts)."""
    from adaptiveisp_tpu_torch.config import TrainConfig
    from adaptiveisp_tpu_torch.detect.model import (
        DetectionModel,
        anchors_in_grid_units,
    )
    from adaptiveisp_tpu_torch.policy.agent import Agent
    from adaptiveisp_tpu_torch.policy.value import Value
    from adaptiveisp_tpu_torch.train.optim import make_optimizer
    from adaptiveisp_tpu_torch.train.step import (
        init_train_state,
        make_train_step,
    )
    from adaptiveisp_tpu_torch.train.trainer import imgsz_hyp

    w, spec = inp["weights"], inp["spec"]
    agent, value = Agent(cfg), Value(cfg)
    agent.load_state_dict(w["agent_state_dict"])
    value.load_state_dict(w["value_state_dict"])
    yolo = DetectionModel(spec)
    yolo.load_state_dict(w["yolo_state_dict"])
    tcfg = TrainConfig(**inp["tcfg"])
    tx = make_optimizer(tcfg.lr, tcfg.max_iter_step)
    vtx = make_optimizer(tcfg.lr * cfg.value_lr_mul, tcfg.max_iter_step)
    state = init_train_state(agent, value, tx, vtx)
    hyp = imgsz_hyp(tcfg.imgsz, nc=spec["nc"], nl=len(spec["anchors"]))
    step = mesh_lib.shard_train_step(make_train_step(
        yolo, cfg, tcfg, anchors_in_grid_units(spec), hyp,
        cached_input_loss=True), mesh)
    batch = mesh_lib.shard_batch(mesh, tuple(inp["step_batch"]))
    gen = None
    if generator_seed is not None:
        gen = torch.Generator().manual_seed(generator_seed)
    runs = []
    for _ in range(n_steps):
        out = step(state, batch, gen, inp["progress"])
        runs.append({"metrics": _metrics(out),
                     "new_states": out.new_states.clone(),
                     "retouch": out.retouch.clone()})
    return {"runs": runs, "agent": _sd(state.agent),
            "value": _sd(state.value)}


def _host_pool_run(cfg, inp, root, mesh=None):
    """``Trainer`` with the host pool (``device_replay=False``) for two
    iterations: its history and the pool's records afterwards.  Over a
    mesh every rank writes the whole gathered batch back into its copy of
    the pool."""
    from adaptiveisp_tpu_torch.config import TrainConfig
    from adaptiveisp_tpu_torch.train.trainer import Trainer

    name = "hexp" if mesh is None else f"hexp{mesh.rank}"
    tr = Trainer(cfg, TrainConfig(**inp["tcfg"]), inp["data"],
                 save_dir=os.path.join(root, name), device="cpu", mesh=mesh,
                 **dict(inp["trainer_kw"], device_replay=False),
                 **inp["weights"])
    try:
        tr.train(max_steps=1)
    finally:
        tr.close()
    return {"history": tr.history,
            "pool": [(os.path.basename(r["path"]), r["im"], r["state"])
                     for r in tr.replay.pool]}


def rl_scenarios(root):
    """The DP step against JAX's sharded step (dropout off) and with
    dropout on, ``Trainer(mesh=)`` for 3 iterations, and
    ``run_validation(mesh=)``."""
    from adaptiveisp_tpu_torch.config import TrainConfig
    from adaptiveisp_tpu_torch.configs.config_fast_filters import cfg as fast
    from adaptiveisp_tpu_torch.data.datasets import ISPDataset
    from adaptiveisp_tpu_torch.detect.model import DetectionModel
    from adaptiveisp_tpu_torch.eval.validator import run_validation
    from adaptiveisp_tpu_torch.policy.agent import Agent
    from adaptiveisp_tpu_torch.train.trainer import Trainer

    mesh, inp = _setup(root)
    cfg = fast.replace(**inp["cfg"])
    out = {"step": _rl_step_runs(mesh, inp, cfg, 2),
           "dropout_step": _rl_step_runs(
               mesh, inp, cfg.replace(dropout_keep_prob=0.5), 1,
               generator_seed=inp["dropout_seed"])}

    tr = Trainer(cfg, TrainConfig(**inp["tcfg"]), inp["data"],
                 save_dir=os.path.join(root, "texp"), device="cpu",
                 mesh=mesh, **inp["trainer_kw"], **inp["weights"])
    try:
        seen, sample = [], tr.device_replay.sample

        def recorded(n):
            got = sample(n)
            seen.append((np.array(got[0]), np.array(got[2])))
            return got

        tr.device_replay.sample = recorded
        tr.train(max_steps=inp["max_steps"])
        pool = tr.device_replay
        out["trainer"] = {
            "seen": seen, "history": tr.history, "step": tr.state.step,
            "divergence_count": tr.divergence_count,
            "images": pool.images.clone(), "loss_in": pool.loss_in.clone(),
            "states": pool.states.copy(),
            "paths": [os.path.basename(m["path"]) for m in pool.meta],
            "agent": _sd(tr.state.agent), "value": _sd(tr.state.value),
            "ckpts": sorted(os.listdir(tr.ckpt_dir))}
    finally:
        tr.close()

    out["host_pool"] = _host_pool_run(cfg, inp, root, mesh)

    # validation of the initial weights
    agent, yolo = Agent(cfg), DetectionModel(inp["spec"])
    agent.load_state_dict(inp["weights"]["agent_state_dict"])
    yolo.load_state_dict(inp["weights"]["yolo_state_dict"])
    ds = ISPDataset(inp["data"], img_size=inp["tcfg"]["imgsz"],
                    source="normalize", train=False)
    res = run_validation(cfg, agent.eval(), yolo.eval(), ds, mesh=mesh,
                         yolo_spec=inp["spec"], **inp["val_kw"])
    out["validation"] = {k: res[k] for k in ("records", "map50", "map")}
    torch.save(out, os.path.join(root, f"rank{mesh.rank}.pt"))


def failing(root):
    """Rank 1 raises while rank 0 still works: the launch must name rank 1
    and stop rank 0."""
    import time

    mesh = mesh_lib.make_mesh(2, device="cpu")
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    time.sleep(120)


# --------------------------------------------------------------------- #
# the detector, segmentation and classifier trainers
# --------------------------------------------------------------------- #
def _first_step(mesh, trainer, batch):
    """One step of ``trainer`` on the rank's rows of ``batch``: the loss
    and the model's and EMA's tensors."""
    state, out = trainer.step_fn(trainer.state,
                                 *mesh_lib.shard_batch(mesh, tuple(batch)))
    return {"loss": out["loss"].detach().clone(), "model": _sd(state.model),
            "ema": {k: v.clone() for k, v in state.ema.params.items()}}


def det_scenarios(root):
    """The first step of ``DetectorTrainer``, ``SegmentTrainer`` and
    ``ClassifierTrainer`` over the mesh."""
    from adaptiveisp_tpu_torch import classify as cls
    from adaptiveisp_tpu_torch.data import detector_dataset as dd
    from adaptiveisp_tpu_torch.data import segment_dataset as sd_mod
    from adaptiveisp_tpu_torch.detect import segment as seg
    from adaptiveisp_tpu_torch.detect import train_detector as td
    from adaptiveisp_tpu_torch.detect import train_loop as tl
    from adaptiveisp_tpu_torch.detect.loss import LossHyp
    from adaptiveisp_tpu_torch.detect.model import DetectionModel

    mesh, inp = _setup(root)
    out = {}
    d = inp["det"]
    model = DetectionModel(d["spec"])
    model.load_state_dict(d["weights"])
    tds = dd.DetectorDataset(d["data"], img_size=d["size"],
                             batch_size=len(d["batch"][0]), augment=False,
                             nc=d["spec"]["nc"])
    tr = tl.DetectorTrainer(model, d["spec"], tds,
                            cfg=td.DetTrainConfig(**d["cfg"]),
                            hyp=LossHyp(**d["hyp"]), loggers=False,
                            device="cpu", mesh=mesh)
    out["det"] = _first_step(mesh, tr, d["batch"])

    s = inp["seg"]
    model = DetectionModel(s["spec"])
    model.load_state_dict(s["weights"])
    sds = sd_mod.SegmentDataset(s["data"], img_size=s["size"],
                                batch_size=len(s["batch"][0]),
                                augment=False, mask_ratio=s["mask_ratio"])
    tr = seg.SegmentTrainer(model, s["spec"], sds,
                            cfg=td.DetTrainConfig(**s["cfg"]),
                            hyp=LossHyp(**s["hyp"]), nm=s["nm"],
                            loggers=False, device="cpu", mesh=mesh)
    out["seg"] = _first_step(mesh, tr, s["batch"])

    c = inp["cls"]
    model = cls.ClassificationModel(spec=c["spec"], nc=c["nc"])
    model.load_state_dict(c["weights"])
    cds = cls.FolderDataset(c["data"], img_size=c["size"])
    tr = cls.ClassifierTrainer(model, cds,
                               cfg=cls.ClsTrainConfig(**c["cfg"]),
                               device="cpu", mesh=mesh)
    ims, labels = mesh_lib.shard_batch(mesh, tuple(c["batch"]))
    state, res = tr.step_fn(tr.state, ims, labels.long())
    out["cls"] = {"loss": res["loss"].clone(), "acc": res["acc"].clone(),
                  "model": _sd(state.model),
                  "ema": {k: v.clone() for k, v in state.ema.params.items()}}
    out["fit"] = _split_fitness_fits(mesh, inp, root)
    torch.save(out, os.path.join(root, f"rank{mesh.rank}.pt"))


# the fitness each rank's own validation gives in the three epochs of
# ``_split_fitness_fits``: rank 0's improves every epoch; rank 1's only in
# the first, so on its own rank 1 would skip two best.pt saves (and their
# barriers) and, with patience 1, stop after the second epoch
LOCAL_FITNESS = ((0.1, 0.2, 0.3), (0.3, 0.2, 0.1))


def _split_fitness_fits(mesh, inp, root):
    """Three epochs of ``DetectorTrainer`` and of ``ClassifierTrainer``
    with patience 1 and checkpoints, each rank's validation replaced by
    one that answers LOCAL_FITNESS[rank]: per trainer, the fitness of
    each epoch, how often this rank validated and the epoch of best.pt."""
    from adaptiveisp_tpu_torch import classify as cls
    from adaptiveisp_tpu_torch.data import detector_dataset as dd
    from adaptiveisp_tpu_torch.detect import train_detector as td
    from adaptiveisp_tpu_torch.detect import train_loop as tl
    from adaptiveisp_tpu_torch.detect.loss import LossHyp
    from adaptiveisp_tpu_torch.detect.model import DetectionModel

    def local_fitness():
        own, calls = iter(LOCAL_FITNESS[mesh.rank]), []

        def next_fit():
            calls.append(1)
            return next(own)

        return next_fit, calls

    out = {}
    d = inp["det"]
    model = DetectionModel(d["spec"])
    model.load_state_dict(d["weights"])
    save = os.path.join(root, "fit_det")
    tr = tl.DetectorTrainer(
        model, d["spec"], dd.DetectorDataset(
            d["data"], img_size=d["size"], batch_size=len(d["batch"][0]),
            augment=False, nc=d["spec"]["nc"]),
        cfg=td.DetTrainConfig(**dict(d["cfg"], epochs=3, patience=1)),
        hyp=LossHyp(**d["hyp"]), save_dir=save, loggers=False,
        device="cpu", mesh=mesh)
    fit, calls = local_fitness()

    def validate():
        f = fit()
        return {"precision": 0.0, "recall": 0.0, "map50": f, "map": f}, f

    tr._validate = validate
    hist = tr.fit()
    out["det"] = {"fitness": [h.fitness for h in hist], "calls": len(calls),
                  "best_epoch": torch.load(os.path.join(save, "best.pt"),
                                           weights_only=False)["epoch"]}

    c = inp["cls"]
    model = cls.ClassificationModel(spec=c["spec"], nc=c["nc"])
    model.load_state_dict(c["weights"])
    save = os.path.join(root, "fit_cls")
    tr = cls.ClassifierTrainer(
        model, cls.FolderDataset(c["data"], img_size=c["size"]),
        cfg=cls.ClsTrainConfig(**dict(c["cfg"], epochs=3, patience=1)),
        save_dir=save, device="cpu", mesh=mesh)
    fit, calls = local_fitness()
    tr.validate = lambda: dict.fromkeys(("top1", "top5"), fit())
    hist = tr.fit()
    out["cls"] = {"fitness": [h["top1"] for h in hist], "calls": len(calls),
                  "best_acc": torch.load(os.path.join(save, "best.pt"),
                                         weights_only=False)["best_acc"]}
    return out
