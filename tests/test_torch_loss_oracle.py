"""The port's detector loss against the independent torch oracle of
``tests/test_loss_torch_oracle.py``.

That file writes the documented target assignment (anchor-ratio filter,
the +-0.5-cell neighbours, clamped grid indices, CIoU, objectness with the
per-level balance, class BCE) directly in torch with dynamic shapes, and
holds the JAX package's static-shape ``per_image_loss`` to it.  Here the
port's ``per_image_loss`` meets the same oracle on the same seeded
predictions and targets (its ``RandomState(71)`` stream replayed: four
trials with 0, 1, 3 and 6 targets), at that test's tolerance (2e-4
relative, 1e-6 absolute), and JAX's ``per_image_loss`` to 1e-5 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptiveisp_tpu.detect.loss import per_image_loss as jper_image_loss
from adaptiveisp_tpu_torch.detect.loss import LossHyp, per_image_loss
from test_loss_torch_oracle import (
    ANCHORS_PX,
    HYP,
    NC,
    STRIDES,
    torch_oracle_loss,
)
from torch_suite import cheap_xla, one_torch_thread  # noqa: F401


def _trials():
    """The oracle test's draws, in its order."""
    rng = np.random.RandomState(71)
    for trial in range(4):
        preds = [rng.randn(16, 16, 3, 5 + NC).astype(np.float32) * 0.5,
                 rng.randn(8, 8, 3, 5 + NC).astype(np.float32) * 0.5]
        n_t = [0, 1, 3, 6][trial]
        targets = np.zeros((8, 5), np.float32)
        for i in range(n_t):
            targets[i] = [rng.randint(0, NC), rng.uniform(0.1, 0.9),
                          rng.uniform(0.1, 0.9), rng.uniform(0.05, 0.6),
                          rng.uniform(0.05, 0.6)]
        tmask = np.zeros((8,), bool)
        tmask[:n_t] = True
        yield preds, targets, tmask, n_t


@pytest.mark.parametrize("trial", range(4))
def test_per_image_loss_matches_torch_oracle(trial):
    preds, targets, tmask, n_t = list(_trials())[trial]
    anchors_grid = [np.asarray(a, np.float32).reshape(-1, 2) / s
                    for a, s in zip(ANCHORS_PX, STRIDES)]
    hyp = LossHyp(box=HYP.box, obj=HYP.obj, cls=HYP.cls,
                  anchor_t=HYP.anchor_t)
    want = torch_oracle_loss(preds, targets[:n_t])
    total, comps = per_image_loss(
        [torch.from_numpy(p) for p in preds], torch.from_numpy(targets),
        torch.from_numpy(tmask), anchors_grid, hyp)
    got = [float(comps[k]) for k in ("box", "obj", "cls")]
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-6)
    assert float(total) == pytest.approx(sum(got), rel=1e-6)
    _, jcomps = jper_image_loss(
        [jnp.asarray(p) for p in preds], jnp.asarray(targets),
        jnp.asarray(tmask), anchors_grid, HYP)
    np.testing.assert_allclose(
        got, [float(jcomps[k]) for k in ("box", "obj", "cls")], rtol=1e-5,
        atol=1e-7)
