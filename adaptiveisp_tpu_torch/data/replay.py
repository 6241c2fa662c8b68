"""Host replay memory: a pool of partly processed images and their RL
states, as NumPy records (port of ``adaptiveisp_tpu/data/replay.py``; the
reference's data flow, every retouched batch copied back to the host).

The pool policy:
  * fill to ``replay_memory_size`` with fresh batches from the feeder
  * pop only non-stopped records, shuffled
  * re-insert the agent's outputs unless the trajectory is longer than
    ``maximum_trajectory_length`` (then keep with ``over_length_keep_prob``),
    then top up
The random streams are the JAX package's: ``RandomState(seed + 1)`` for the
noise, ``random.Random(seed + 2)`` for shuffles and keeps.
"""

from __future__ import annotations

import random
from typing import Dict, List

import numpy as np

from adaptiveisp_tpu_torch.data.datasets import BatchFeeder, ISPDataset
from adaptiveisp_tpu_torch.policy.states import (
    STATE_STEP_DIM,
    STATE_STOPPED_DIM,
    get_initial_states,
    get_noise,
)


class ReplayMemory:
    def __init__(self, cfg, dataset: ISPDataset, batch_size: int,
                 load: bool = True, feeder_batch: int = 64, seed: int = 0,
                 prefetch: bool = True):
        """load=False leaves the pool empty until the first sample (or
        ``fill_pool``); prefetch is the feeder's."""
        self.cfg = cfg
        self.dataset = dataset
        self.batch_size = batch_size
        self.feeder = BatchFeeder(dataset, batch_size=feeder_batch,
                                  prefetch=prefetch, seed=seed)
        self.pool: List[Dict] = []
        self.target_pool_size = cfg.replay_memory_size
        self.rng = np.random.RandomState(seed + 1)
        self._py_rng = random.Random(seed + 2)
        if load:
            self.fill_pool()

    # ------------------------------------------------------------------ #
    def fill_pool(self):
        while len(self.pool) < self.target_pool_size:
            batch = self.feeder.next_batch()
            for i in range(len(batch["im"])):
                self.pool.append({
                    "im": batch["im"][i],
                    "label": batch["label"][i],
                    "path": batch["path"][i],
                    "shape": batch["shape"][i],
                    "state": get_initial_states(
                        1, self.cfg.num_state_dim)[0],
                })
        self.pool = self.pool[:self.target_pool_size]

    def get_feed_dict_and_states(self, batch_size: int) -> Dict:
        records = self._next_unstopped(batch_size)
        return {
            "im": np.stack([r["im"] for r in records], 0),
            "label": [r["label"] for r in records],
            "path": [r["path"] for r in records],
            "shape": [r["shape"] for r in records],
            "state": np.stack([r["state"] for r in records], 0),
            "z": get_noise(self.rng, batch_size, self.cfg.z_dim,
                           self.cfg.z_type),
        }

    def _next_unstopped(self, batch_size: int):
        self._py_rng.shuffle(self.pool)
        assert batch_size <= self.target_pool_size
        batch = []
        while len(batch) < batch_size:
            if not self.pool:
                self.fill_pool()
            record = self.pool.pop(0)
            if record["state"][STATE_STOPPED_DIM] != 1:
                batch.append(record)
        return batch

    def replace_memory(self, images, labels, paths, shapes, states):
        """Re-insert processed records + top up with fresh RAWs."""
        self._py_rng.shuffle(self.pool)
        for i in range(len(images)):
            state = states[i]
            if (state[STATE_STEP_DIM] < self.cfg.maximum_trajectory_length
                    or self._py_rng.random()
                    < self.cfg.over_length_keep_prob):
                self.pool.append({
                    "im": images[i],
                    "label": labels[i],
                    "path": paths[i],
                    "shape": shapes[i],
                    "state": state,
                })
        self.fill_pool()
        self._py_rng.shuffle(self.pool)

    # ------------------------------------------------------------------ #
    def stats(self) -> Dict[str, float]:
        """Pool statistics (reference debug print, replay_memory.py:223-230)."""
        if not self.pool:
            return {"size": 0, "avg_trajectory": 0.0}
        total = sum(float(r["state"][STATE_STEP_DIM]) for r in self.pool)
        return {"size": len(self.pool),
                "avg_trajectory": total / len(self.pool)}

    def stop(self):
        self.feeder.stop()
