"""Device-resident replay memory (port of
``adaptiveisp_tpu/data/replay_device.py``).

The image pool is one ``[P, H, W, 3]`` float32 tensor on the device, with
each slot's cached detector input loss ``[P, 1]`` beside it; the slot
metadata (labels, paths, shapes) and the state matrix stay on the host.  A
step samples with ``index_select`` and writes its kept rows back with
``index_copy_``, so in steady state the only image traffic between host and
device is the upload of fresh images into refreshed slots.

The pool policy is :class:`~adaptiveisp_tpu_torch.data.replay.ReplayMemory`'s:
  * sample only non-stopped slots, ``rng.choice(live, n, replace=False)``
  * after a step, write each retouched image back into its slot unless its
    trajectory stopped or is over length (then kept with probability
    ``over_length_keep_prob``); those slots get fresh images
  * a diverged batch (NaN or brightness guard) refreshes its sampled slots
    and writes nothing back
Fresh images come from the queue of decoded feeder leftovers first.  The
random streams are the JAX package's: ``RandomState(seed + 1)`` for the
choice and the noise, ``random.Random(seed + 2)`` for the over-length keep.

Over a data mesh (``mesh=``, :mod:`..parallel`) the pool is sharded as the
JAX package shards it: rank r holds the images and cached losses of slots
[r P/D, (r+1) P/D); the slot metadata and states stay whole on every rank.
Every rank runs the same feeder and random streams, so every rank makes the
same decisions: sampling draws B/D live slots from each shard's range, one
shard after another; a write-back keeps what the whole batch's new states
say; a refresh decodes the same fresh images on every rank and each rank
uploads (and seeds the losses of) the slots in its own shard.  Batch rows
[r B/D, (r+1) B/D) come from shard r, so a rank gathers and writes back only
its own rows.

Spans (only while a profiler records, ``obs/profile.py``): ``pool.sample``,
``pool.writeback`` (``replace``), ``pool.refresh``, ``pool.seed_loss`` and
``feeder.wait`` (a refresh waiting for the feeder's next decoded batch);
each blocking upload is counted as ``host_read.upload.pool``.
"""

from __future__ import annotations

import random
from typing import Dict, List

import numpy as np
import torch

from adaptiveisp_tpu_torch.data.datasets import BatchFeeder, ISPDataset
from adaptiveisp_tpu_torch.obs.profile import count, span
from adaptiveisp_tpu_torch.policy.states import (
    STATE_STEP_DIM,
    STATE_STOPPED_DIM,
    get_initial_states,
    get_noise,
)


class DeviceReplayMemory:
    def __init__(self, cfg, dataset: ISPDataset, batch_size: int,
                 feeder_batch: int = 32, seed: int = 0,
                 prefetch: bool = True, mesh=None, loss_fn=None,
                 device="cuda"):
        """prefetch is the feeder's.
        loss_fn (optional): callable(images [n, H, W, 3] tensor on the
        device, labels list) -> [n, 1] detector input losses on the device.
        When given, the pool caches each slot's loss: the detector is
        frozen, so a write-back's retouch loss is the next sample's input
        loss, and the train step skips one detector forward."""
        self.cfg = cfg
        self.batch_size = batch_size
        self.pool_size = cfg.replay_memory_size
        self.device = torch.device(device)
        self.mesh = mesh
        self.n_shards = 1 if mesh is None else mesh.data_size
        if self.pool_size % self.n_shards:
            raise ValueError(
                f"replay_memory_size {self.pool_size} must divide evenly "
                f"over {self.n_shards} mesh shards")
        self.shard_size = self.pool_size // self.n_shards
        # this rank's slots [lo, lo + shard_size)
        self.lo = 0 if mesh is None else mesh.data_rank * self.shard_size
        self.feeder = BatchFeeder(dataset, batch_size=feeder_batch,
                                  prefetch=prefetch, seed=seed)
        self.rng = np.random.RandomState(seed + 1)
        self._py_rng = random.Random(seed + 2)
        self._fresh_queue: List = []  # decoded-but-unused feeder leftovers
        self.fresh_images = 0   # images decoded into refreshed slots
        self.refreshes = 0      # slots refreshed

        images = []
        self.meta: List[Dict] = []
        while len(images) < self.pool_size:
            b = self.feeder.next_batch()
            for i in range(len(b["im"])):
                images.append(b["im"][i])
                self.meta.append({"label": b["label"][i],
                                  "path": b["path"][i],
                                  "shape": b["shape"][i]})
        images = images[:self.pool_size]
        self.meta = self.meta[:self.pool_size]
        own = slice(self.lo, self.lo + self.shard_size)
        self.images = torch.from_numpy(np.stack(images[own], 0)).to(
            self.device)
        self.states = get_initial_states(self.pool_size, cfg.num_state_dim)

        self.loss_fn = loss_fn
        self.loss_in = torch.zeros((self.shard_size, 1), dtype=torch.float32,
                                   device=self.device)
        if loss_fn is not None:
            self.loss_in.copy_(self._seed_losses(
                self.images, [m["label"] for m in self.meta[own]]))

    def _index(self, idx) -> torch.Tensor:
        count("host_read.upload.pool")
        return torch.as_tensor(np.asarray(idx, np.int64), device=self.device)

    def _own_rows(self, n: int) -> np.ndarray:
        """Batch positions of this rank's rows in a batch of ``n``."""
        per = n // self.n_shards
        r = 0 if self.mesh is None else self.mesh.data_rank
        return np.arange(r * per, (r + 1) * per)

    # ------------------------------------------------------------------ #
    def sample(self, batch_size: int):
        """Pick non-stopped slots; returns (slot_idx, device_images,
        states, labels, paths, shapes, z), everything for the whole batch
        but the images, which are this rank's rows over a mesh."""
        with span("pool.sample"):
            return self._sample(batch_size)

    def _sample(self, batch_size: int):
        if self.mesh is None:
            live = np.where(self.states[:, STATE_STOPPED_DIM] != 1)[0]
            if len(live) < batch_size:
                self._refresh_slots(
                    np.where(self.states[:, STATE_STOPPED_DIM] == 1)[0])
                live = np.where(self.states[:, STATE_STOPPED_DIM] != 1)[0]
            idx = self.rng.choice(live, size=batch_size, replace=False)
        else:
            if batch_size % self.n_shards:
                raise ValueError(f"batch {batch_size} must divide over "
                                 f"{self.n_shards} shards")
            bps = batch_size // self.n_shards
            picks = []
            for s in range(self.n_shards):
                lo = s * self.shard_size
                stopped = self.states[lo:lo + self.shard_size,
                                      STATE_STOPPED_DIM] == 1
                live = lo + np.where(~stopped)[0]
                if len(live) < bps:
                    self._refresh_slots(lo + np.where(stopped)[0])
                    stopped = self.states[lo:lo + self.shard_size,
                                          STATE_STOPPED_DIM] == 1
                    live = lo + np.where(~stopped)[0]
                picks.append(self.rng.choice(live, size=bps, replace=False))
            idx = np.concatenate(picks)
        own = idx[self._own_rows(batch_size)]
        imgs = self.images.index_select(0, self._index(own - self.lo))
        labels = [self.meta[i]["label"] for i in idx]
        paths = [self.meta[i]["path"] for i in idx]
        shapes = [self.meta[i]["shape"] for i in idx]
        z = get_noise(self.rng, batch_size, self.cfg.z_dim, self.cfg.z_type)
        return idx, imgs, self.states[idx].copy(), labels, paths, shapes, z

    def sampled_loss(self, idx: np.ndarray) -> torch.Tensor:
        """Cached input losses of the sampled slots, [n, 1] on the device
        (this rank's rows over a mesh)."""
        own = idx[self._own_rows(len(idx))]
        return self.loss_in.index_select(0, self._index(own - self.lo))

    def replace(self, idx: np.ndarray, retouch: torch.Tensor,
                new_states: np.ndarray, diverged: bool = False,
                retouch_loss=None):
        """Write the step's outputs back into their slots, on the device.

        retouch_loss [n, 1] (device): each image's retouch detector loss,
        its slot's cached input loss at its next sampling.  Over a mesh
        ``retouch`` holds this rank's rows; ``new_states`` and
        ``retouch_loss`` the whole batch's."""
        with span("pool.writeback"):
            self._replace(idx, retouch, new_states, diverged, retouch_loss)

    def _replace(self, idx, retouch, new_states, diverged, retouch_loss):
        if diverged:
            self._refresh_slots(idx)
            return
        keep, refresh = [], []
        for pos, slot in enumerate(idx):
            st = new_states[pos]
            # a stopped trajectory is done: the reference re-inserts it,
            # discards it at the next pop and tops the pool up with a fresh
            # image; here the slot gets the fresh image at once
            stopped = st[STATE_STOPPED_DIM] == 1
            overlong = (st[STATE_STEP_DIM]
                        >= self.cfg.maximum_trajectory_length
                        and self._py_rng.random()
                        >= self.cfg.over_length_keep_prob)
            if stopped or overlong:
                refresh.append(slot)
            else:
                keep.append(pos)
        if keep:
            keep_pos = np.asarray(keep)
            self.states[idx[keep_pos]] = new_states[keep_pos]
            mine = self._own_rows(len(idx))
            own_pos = keep_pos[np.isin(keep_pos, mine)]
            if len(own_pos):
                slots = self._index(idx[own_pos] - self.lo)
                rows = self._index(own_pos - mine[0])
                self.images.index_copy_(0, slots,
                                        retouch.index_select(0, rows))
                if self.loss_fn is not None and retouch_loss is not None:
                    self.loss_in.index_copy_(0, slots, retouch_loss
                                             .index_select(
                                                 0, self._index(own_pos)))
        if refresh:
            self._refresh_slots(np.asarray(refresh))

    def _refresh_slots(self, slots: np.ndarray):
        """Load fresh images into the given slots: one upload, one
        ``index_copy_``, and their losses seeded on the device."""
        if len(slots) == 0:
            return
        with span("pool.refresh"):
            self._refresh(slots)

    def _refresh(self, slots: np.ndarray):
        fresh = self._fresh_queue
        while len(fresh) < len(slots):
            with span("feeder.wait"):
                b = self.feeder.next_batch()
            self.fresh_images += len(b["im"])
            for i in range(len(b["im"])):
                fresh.append((b["im"][i], {
                    "label": b["label"][i], "path": b["path"][i],
                    "shape": b["shape"][i]}))
        self._fresh_queue = fresh[len(slots):]
        fresh = fresh[:len(slots)]
        self.refreshes += len(slots)
        for slot, (_, meta) in zip(slots, fresh):
            self.meta[slot] = meta
        self.states[slots] = get_initial_states(len(slots),
                                                self.cfg.num_state_dim)
        slots = np.asarray(slots)
        mine = np.where((slots >= self.lo)
                        & (slots < self.lo + self.shard_size))[0]
        if not len(mine):
            return
        count("host_read.upload.pool")
        vals = torch.from_numpy(np.stack([fresh[i][0] for i in mine], 0)).to(
            self.device)
        index = self._index(slots[mine] - self.lo)
        self.images.index_copy_(0, index, vals)
        if self.loss_fn is not None:
            self.loss_in.index_copy_(0, index, self._seed_losses(
                vals, [fresh[i][1]["label"] for i in mine]))

    def _seed_losses(self, images: torch.Tensor, labels) -> torch.Tensor:
        """Detector input losses of device images, in chunks of the feeder
        batch (no padding: each image's loss is its own)."""
        fb = max(1, self.feeder.batch_size)
        with span("pool.seed_loss"):
            return torch.cat([self.loss_fn(images[s:s + fb],
                                           labels[s:s + fb])
                              for s in range(0, images.shape[0], fb)], 0)

    # ------------------------------------------------------------------ #
    def stats(self) -> Dict[str, float]:
        return {"size": self.pool_size,
                "avg_trajectory": float(self.states[:, STATE_STEP_DIM].mean())}

    def stop(self):
        self.feeder.stop()
