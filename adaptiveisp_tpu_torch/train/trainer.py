"""The RL trainer (port of ``adaptiveisp_tpu/train/trainer.py``).

A host loop around the actor-critic step of :mod:`.step`:
  1. sample a batch of non-stopped records from the replay pool
  2. run the step (agent forward with the blend render, the frozen
     detector's reward, the critic twice, one backward pass, both
     optimizers)
  3. the divergence guard (NaN, or a mean brightness outside
     [0.01, max_brightness]) refreshes the sampled slots, else the
     retouched images are written back into the pool
  4. metrics, validation trajectories and checkpoints at their cadences

The device pool (:mod:`..data.replay_device`) keeps the images on the
device: per iteration one host fetch brings the scalar metrics and the new
states; the retouched images stay where they are.  The host pool
(:mod:`..data.replay`) is the reference's data flow.

Over a data mesh (``mesh=``, :mod:`.mesh`) every rank runs this loop with
the same seeds: the same pool decisions and feeds, its own rows of each
batch, the step of :func:`.mesh.shard_train_step` (global BatchNorm,
dropout and metrics; gradients averaged before the clip), the device pool
sharded by slot.  Rank 0 alone prints, logs, dumps validation
trajectories and writes checkpoints, the others waiting at a barrier.

Spans (only while a profiler records, ``obs/profile.py``):
``trainer.iteration`` around each iteration, and inside it
``trainer.upload`` (the batch's targets and host arrays onto the device),
``trainer.fetch`` (the host fetch, counted as ``host_read.trainer``),
``trainer.log`` (history, writer, printing), ``trainer.validate``,
``trainer.checkpoint`` and ``train_step`` (the step); the pool's spans and
the step's scopes nest inside.
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Callable, Mapping, Optional

import numpy as np
import torch

from adaptiveisp_tpu_torch import api
from adaptiveisp_tpu_torch.config import Config, TrainConfig
from adaptiveisp_tpu_torch.data.datasets import ISPDataset
from adaptiveisp_tpu_torch.data.replay import ReplayMemory
from adaptiveisp_tpu_torch.detect.loss import LossHyp, pad_targets
from adaptiveisp_tpu_torch.detect.model import anchors_in_grid_units
from adaptiveisp_tpu_torch.detect.spec import YOLOV3_SPEC
from adaptiveisp_tpu_torch.eval.rollout import no_pipeline, rollout
from adaptiveisp_tpu_torch.obs.logging import MetricWriter, save_img
from adaptiveisp_tpu_torch.obs.profile import count, span
from adaptiveisp_tpu_torch.ops.bank import short_names
from adaptiveisp_tpu_torch.policy.states import get_initial_states
from adaptiveisp_tpu_torch.train import checkpoint as ckpt_lib
from adaptiveisp_tpu_torch.train import mesh as mesh_lib
from adaptiveisp_tpu_torch.train.optim import make_optimizer
from adaptiveisp_tpu_torch.train.step import (
    init_train_state,
    make_input_loss_fn,
    make_train_step,
)

# the step's scalar metrics, fetched to the host in one transfer with the
# selections and the new states
SCALARS = ("agent_loss", "value_loss", "detect_input_loss",
           "detect_retouch_loss", "reward", "penalty", "q_value",
           "retouch_mean", "retouch_finite")


def imgsz_hyp(imgsz: int, nc: int = 80, nl: int = 3) -> LossHyp:
    """The trainer's hyp scaling: box *= 3/nl, cls *= nc/80 * 3/nl,
    obj *= (imgsz/640)^2 * 3/nl."""
    return LossHyp(box=0.05 * 3 / nl,
                   cls=0.5 * nc / 80 * 3 / nl,
                   obj=1.0 * (imgsz / 640) ** 2 * 3 / nl)


def fetch_metrics(metrics, new_states):
    """One device-to-host transfer: the scalar metrics (``SCALARS``), the
    selections and the new states -> (dict of NumPy values, states)."""
    n = new_states.shape[0]
    count("host_read.trainer")
    packed = torch.cat([
        torch.stack([metrics[k].to(torch.float32) for k in SCALARS]),
        metrics["selected_filter"].to(torch.float32),
        new_states.to(torch.float32).reshape(-1)]).cpu().numpy()
    out = {k: packed[i] for i, k in enumerate(SCALARS)}
    out["retouch_finite"] = bool(out["retouch_finite"])
    k = len(SCALARS)
    out["selected_filter"] = packed[k:k + n].astype(np.int32)
    return out, packed[k + n:].reshape(n, -1).copy()


class Trainer:
    """Builds the datasets, the networks, the step and the replay pool;
    ``train`` runs the loop, ``close`` stops the pool's feeder thread.

    Networks start from seeded random weights (agent ``tcfg.seed``, critic
    ``+1``, detector ``+2``) unless a ``state_dict`` is given (e.g. from
    ``convert.*_from_flax``).  Runs on ``device``, ``cuda`` by default,
    or on ``mesh.device`` for one rank of a data mesh (``mesh=``, from
    :func:`.mesh.make_mesh`; rank 0's weights are broadcast).
    """

    def __init__(self, cfg: Config, tcfg: TrainConfig,
                 train_path: str, val_path: Optional[str] = None,
                 save_dir: str = "experiments/adaptiveisp-tpu",
                 yolo_state_dict: Optional[Mapping] = None, t_max: int = 64,
                 data_source: Optional[str] = None, log: bool = True,
                 yolo_spec=None, yolo_dtype="bfloat16",
                 device_replay: bool = False, cached_reward: bool = True,
                 loss_hyp: Optional[LossHyp] = None, device="cuda",
                 agent_state_dict: Optional[Mapping] = None,
                 value_state_dict: Optional[Mapping] = None, mesh=None):
        cfg = cfg.replace(
            filter_runtime_penalty=tcfg.runtime_penalty,
            filter_runtime_penalty_lambda=tcfg.runtime_penalty_lambda)
        self.cfg = cfg
        self.tcfg = tcfg
        self.t_max = t_max
        self.save_dir = save_dir
        self.mesh = mesh
        self.is_main = mesh is None or mesh.is_main
        self.device = (api.resolve_device(device) if mesh is None
                       else mesh.device)

        os.makedirs(save_dir, exist_ok=True)
        self.log_dir = os.path.join(save_dir, "logs")
        self.ckpt_dir = os.path.join(save_dir, "ckpt")
        self.image_dir = os.path.join(save_dir, "images")
        for d in (self.log_dir, self.ckpt_dir, self.image_dir):
            os.makedirs(d, exist_ok=True)
        self.writer = (MetricWriter(self.log_dir) if log and self.is_main
                       else None)

        source = data_source or (
            "raw" if tcfg.data_name == "coco" else
            "rod" if tcfg.data_name == "rod" else "normalize")
        train_ds = ISPDataset(
            train_path, img_size=tcfg.imgsz, source=source, train=True,
            add_noise=tcfg.add_noise, brightness_range=tcfg.bri_range,
            noise_level=tcfg.noise_level, use_linear=tcfg.use_linear)
        self.device_replay = None
        self.cached_reward = bool(device_replay and cached_reward)
        # static target capacity: never truncate a crowded image
        # (pad_targets keeps min(n, t_max))
        if getattr(train_ds, "labels", None):
            dense = max((len(lb) for lb in train_ds.labels), default=0)
            if dense > t_max:
                self.t_max = int(np.ceil(dense / 16) * 16)
                print(f"t_max raised to {self.t_max} (densest train image "
                      f"has {dense} labels)")
        self.val_feed = None
        if val_path is not None:
            val_ds = ISPDataset(val_path, img_size=tcfg.imgsz, source=source,
                                train=False)
            val_replay = ReplayMemory(cfg, val_ds, tcfg.batch_size,
                                      seed=tcfg.seed + 100)
            try:
                self.val_feed = val_replay.get_feed_dict_and_states(
                    min(8, cfg.replay_memory_size))
            finally:
                val_replay.stop()

        # ---- networks, optimizers and the step ------------------------
        dev = self.device
        self.agent = api.load_adaptive_isp(
            cfg=cfg, seed=tcfg.seed, device=dev,
            state_dict=agent_state_dict).agent
        self.value = api.load_value(cfg, seed=tcfg.seed + 1, device=dev,
                                    state_dict=value_state_dict)
        spec = yolo_spec or YOLOV3_SPEC
        self.yolo_spec = spec
        # the frozen reward detector runs in bf16 by default: the reward is
        # the difference of two clipped losses through the same detector,
        # so the rounding largely cancels; "float32" for parity runs
        if yolo_dtype in ("bfloat16", "bf16"):
            yolo_dtype = torch.bfloat16
        elif yolo_dtype in ("float32", "f32"):
            yolo_dtype = None
        self.yolo = api.load_detector(spec=spec, seed=tcfg.seed + 2, device=dev,
                                      state_dict=yolo_state_dict,
                                      dtype=yolo_dtype).model
        hyp = (loss_hyp if loss_hyp is not None
               else imgsz_hyp(tcfg.imgsz, nc=spec["nc"],
                              nl=len(spec["anchors"])))
        max_iter = tcfg.max_iter_step
        agent_tx = make_optimizer(
            tcfg.lr, max_iter, clip_norm=tcfg.grad_clip_norm,
            lr_decay=tcfg.lr_decay, segments=tcfg.lr_segments)
        value_tx = make_optimizer(
            tcfg.lr * cfg.value_lr_mul, max_iter,
            clip_norm=tcfg.grad_clip_norm, lr_decay=tcfg.lr_decay,
            segments=tcfg.lr_segments)
        anchors = anchors_in_grid_units(spec)
        for net in (self.agent, self.value, self.yolo):
            mesh_lib.replicate(mesh, net)
        self.train_step = make_train_step(
            self.yolo, cfg, tcfg, anchors, hyp,
            cached_input_loss=self.cached_reward)
        if mesh is not None:
            self.train_step = mesh_lib.shard_train_step(self.train_step, mesh)
        self.state = init_train_state(self.agent, self.value, agent_tx,
                                      value_tx)
        self.filter_names = short_names(cfg)
        self.generator = torch.Generator(device=dev)
        self.generator.manual_seed(tcfg.seed + 7)
        # per-iteration scalars (reward, losses)
        self.history: list = []
        # NaN/brightness guard trips
        self.divergence_count = 0

        # ---- replay pool (after the networks: the cached reward seeds
        # each slot's input loss with the detector) ---------------------
        if device_replay:
            from adaptiveisp_tpu_torch.data.replay_device import (
                DeviceReplayMemory,
            )

            pool_loss_fn = None
            if self.cached_reward:
                raw_loss = make_input_loss_fn(self.yolo, cfg, anchors, hyp)

                def pool_loss_fn(images, labels):
                    targets, tmask = pad_targets(labels, self.t_max)
                    count("host_read.upload.pool", 2)
                    return raw_loss(images,
                                    torch.from_numpy(targets).to(dev),
                                    torch.from_numpy(tmask).to(dev))

            self.device_replay = DeviceReplayMemory(
                cfg, train_ds, tcfg.batch_size, seed=tcfg.seed, device=dev,
                loss_fn=pool_loss_fn, mesh=mesh)
            self.replay = self.device_replay  # stats/stop interface
        else:
            self.replay = ReplayMemory(cfg, train_ds, tcfg.batch_size,
                                       seed=tcfg.seed)

    # ------------------------------------------------------------------ #
    def resume(self, path_or_dir: str):
        step = ckpt_lib.latest_step(path_or_dir)
        if step is not None:
            self.state = ckpt_lib.restore(path_or_dir, self.state)
            print(f"Resumed from {path_or_dir} @ step {step}")

    def _to_device(self, *arrays):
        """This rank's rows of host arrays, on its device (blocking
        uploads)."""
        count("host_read.upload.trainer", len(arrays))
        if self.mesh is not None:
            return mesh_lib.shard_batch(self.mesh, tuple(
                np.asarray(a) for a in arrays))
        return tuple(torch.from_numpy(np.asarray(a)).to(self.device)
                     for a in arrays)

    def train(self, max_steps: Optional[int] = None,
              print_freq: Optional[int] = None,
              mark: Optional[Callable[[str], None]] = None):
        """Iterations ``state.step`` .. ``max_steps`` (default: the
        schedule's ``max_iter_step``), inclusive.

        mark(name), when given, is called at each iteration's "start", after
        "sample" (the batch on the device), after each of the step's phases
        ("agent", "detector", "critic", "backward", "optimizer"), after
        "writeback" (the host fetch, the guard, the pool update), after
        "validate" (metrics, validation trajectories) and at its "end"
        (checkpoints): timing hooks."""
        cfg, tcfg = self.cfg, self.tcfg
        max_iter = tcfg.max_iter_step if max_steps is None else max_steps
        print_freq = print_freq or cfg.print_freq
        mark = mark or (lambda name: None)
        mloss_agent = mloss_value = 0.0
        t_start = time.time()

        device_pool = self.device_replay is not None
        # continue from the restored step after resume(): checkpoint ids
        # keep advancing and the progress-annealed penalties don't rewind
        start_it = int(self.state.step)
        for it in range(start_it, max_iter + 1):
            with span("trainer.iteration"):
                mark("start")
                k = it - start_it  # iterations of this run (means, ETA)
                progress = it / max(tcfg.max_iter_step, 1)
                if device_pool:
                    idx, imgs, states_np, labels, paths, shapes, z = (
                        self.device_replay.sample(tcfg.batch_size))
                    with span("trainer.upload"):
                        targets, tmask = pad_targets(labels, self.t_max)
                        batch = (imgs,) + self._to_device(
                            z, states_np, targets, tmask)
                        if self.cached_reward:
                            batch = batch + (
                                self.device_replay.sampled_loss(idx),)
                else:
                    feed = self.replay.get_feed_dict_and_states(
                        tcfg.batch_size)
                    with span("trainer.upload"):
                        targets, tmask = pad_targets(feed["label"], self.t_max)
                        batch = self._to_device(feed["im"], feed["z"],
                                                feed["state"], targets, tmask)
                mark("sample")

                # the step's own host work (the reward, the critic's terms,
                # the backward pass) apart from the loop's
                with span("train_step"):
                    out = self.train_step(self.state, batch, self.generator,
                                          progress, mark)
                self.state = out.state

                # ---- divergence guard + pool update ------------------------
                if device_pool:
                    # one host fetch: metrics and the small state matrix; the
                    # retouched images stay on the device
                    with span("trainer.fetch"):
                        metrics, new_states = fetch_metrics(out.metrics,
                                                            out.new_states)
                    mean_b = float(metrics["retouch_mean"])
                    diverged = (not metrics["retouch_finite"]
                                or mean_b < 0.01
                                or mean_b > tcfg.max_brightness)
                    if diverged:
                        self.divergence_count += 1
                        if self.is_main:
                            print(f"retouch diverged (mean={mean_b:.4f}); "
                                  f"refreshing slots")
                    self.device_replay.replace(
                        idx, out.retouch, new_states, diverged=diverged,
                        retouch_loss=(out.metrics["retouch_loss_per_image"]
                                      if self.cached_reward else None))
                else:
                    with span("trainer.fetch"):
                        retouch = out.retouch
                        if self.mesh is not None:
                            retouch = mesh_lib.all_gather(self.mesh, retouch)
                        count("host_read.trainer")
                        retouch = retouch.cpu().numpy()
                        metrics, new_states = fetch_metrics(out.metrics,
                                                            out.new_states)
                    mean_b = float(retouch.mean())
                    if (not np.isfinite(retouch).all() or mean_b < 0.01
                            or mean_b > tcfg.max_brightness):
                        self.divergence_count += 1
                        if self.is_main:
                            print(f"retouch diverged (mean={mean_b:.4f}); "
                                  f"refilling pool")
                        self.replay.fill_pool()
                    else:
                        self.replay.replace_memory(
                            list(retouch), feed["label"], feed["path"],
                            feed["shape"], list(new_states))
                mark("writeback")
                with span("trainer.log"):
                    mloss_agent, mloss_value = self._log(
                        it, k, max_iter, print_freq, metrics, mloss_agent,
                        mloss_value, t_start)
                if (it > 0 and it % cfg.val_freq == 0
                        and self.val_feed is not None and self.is_main):
                    with span("trainer.validate"):
                        self.validate_trajectories(it)
                mark("validate")
                if it > 0 and it % cfg.save_model_freq == 0:
                    with span("trainer.checkpoint"):
                        if self.is_main:
                            ckpt_lib.save(self.ckpt_dir, self.state, it)
                            # the reference's weights-only artifact for
                            # inference
                            ckpt_lib.save_weights_only(
                                os.path.join(self.ckpt_dir,
                                             f"weights_iter_{it}.pt"),
                                self.state)
                        mesh_lib.sync_global_devices(self.mesh)
                mark("end")
        return self.state

    def _log(self, it, k, max_iter, print_freq, metrics, mloss_agent,
             mloss_value, t_start):
        """The iteration's history row, writer scalars and printed line;
        returns the running mean losses."""
        cfg = self.cfg
        mloss_agent = ((mloss_agent * k + float(metrics["agent_loss"]))
                       / (k + 1))
        mloss_value = ((mloss_value * k + float(metrics["value_loss"]))
                       / (k + 1))
        self.history.append({
            "reward": float(metrics["reward"]),
            "penalty": float(metrics["penalty"]),
            "agent_loss": float(metrics["agent_loss"]),
            "value_loss": float(metrics["value_loss"]),
            "detect_input_loss": float(metrics["detect_input_loss"]),
            "detect_retouch_loss": float(metrics["detect_retouch_loss"]),
        })
        if self.writer is not None and it % cfg.summary_freq == 0:
            self.writer.scalars({
                "agent_loss": float(metrics["agent_loss"]),
                "value_loss": float(metrics["value_loss"]),
                "detect_loss": float(metrics["detect_retouch_loss"]),
                "reward": float(metrics["reward"]),
                "penalty": float(metrics["penalty"]),
            }, it)
        if it % print_freq == 0 and self.is_main:
            sel = metrics["selected_filter"]
            names = [self.filter_names[int(s)] for s in sel[:4]]
            stats = self.replay.stats()
            print(datetime.datetime.now().strftime("%H:%M:%S"),
                  f"[{it}/{max_iter}]",
                  f"agent {mloss_agent:.4f} value {mloss_value:.4f}",
                  f"reward {float(metrics['reward']):.3e}",
                  f"penalty {float(metrics['penalty']):.3e}",
                  f"sel {names}",
                  f"pool {stats['size']}/{stats['avg_trajectory']:.2f}",
                  f"({(time.time() - t_start) / (k + 1):.2f}s/it)")
        return mloss_agent, mloss_value

    # ------------------------------------------------------------------ #
    def validate_trajectories(self, it: int, max_images: int = 2):
        """Eval-mode rollouts of the fixed validation batch with per-step
        image dumps and a trajectory strip per image."""
        from adaptiveisp_tpu_torch.obs.visualize import trajectory_strip

        feed, cfg, dev = self.val_feed, self.cfg, self.device
        agent, steps = self.state.agent, cfg.test_steps
        agent.eval()   # BatchNorm on its running statistics, no dropout
        try:
            for b in range(min(max_images, len(feed["im"]))):
                # three uploads and three reads back per image
                count("host_read.upload.trainer", 3)
                count("host_read.trainer", 3)
                img = torch.from_numpy(feed["im"][b:b + 1]).to(dev)
                noises = torch.from_numpy(np.stack(
                    [np.random.RandomState(it * 10 + i).uniform(
                        0, 1, (1, cfg.z_dim)).astype(np.float32)
                     for i in range(steps)])).to(dev)
                states = torch.from_numpy(get_initial_states(
                    1, cfg.num_state_dim)).to(dev)
                res = rollout(agent, img, noises, states,
                              no_pipeline(steps), record_steps=True)
                per_step = res.images_per_step[:, 0].cpu().numpy()
                for i in range(steps):
                    save_img(per_step[i], os.path.join(
                        self.image_dir, f"val{b}_iter{it}_step{i}.png"))
                strip = trajectory_strip(
                    [feed["im"][b]] + list(per_step),
                    list(res.pdfs[:, 0].cpu().numpy()),
                    [int(s) for s in res.selected[:, 0].cpu()])
                save_img(strip, os.path.join(self.image_dir,
                                             f"val{b}_iter{it}_steps.png"))
                if self.writer is not None:
                    self.writer.image(f"val_{b}", strip, it)
        finally:
            agent.train()

    def close(self):
        self.replay.stop()
        if self.writer is not None:
            self.writer.close()
