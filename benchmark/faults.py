"""Faults planted in the program, each a context manager that patches one
seam of the port and puts it back.  ``benchmark/tests/test_bench_faults.py``
runs a cell under each on the CPU and sees ``correct`` come out false;
``control.py`` reads the training faults on the card, where they set the
upper readings of the limits.  The benchmark's own runs plant nothing."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def patched(owner, name: str, value):
    orig = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, orig)


# ------------------------------------------------------------- inference


def half_batch():
    """Half of each batch left out: only the first half is rolled out, the
    rest handed back as it came."""
    from adaptiveisp_tpu_torch import api

    orig = api.AdaptiveISP.process_with_trace

    def half(self, images, pipeline=None, seed=None, record_steps=True):
        n = images.shape[0] // 2
        res = orig(self, images[:n], pipeline, seed, record_steps)
        rest = images[n:].to(res.image.device)
        return res._replace(
            image=torch.cat([res.image, rest]),
            selected=torch.cat([res.selected, res.selected], 1),
            params=torch.cat([res.params, res.params], 1))

    return patched(api.AdaptiveISP, "process_with_trace", half)


def answer_altered():
    """Every detection's box moved by one pixel where NMS produces it."""
    from adaptiveisp_tpu_torch import api

    orig = api.non_max_suppression

    def moved(*a, **k):
        dets, n = orig(*a, **k)
        dets = dets.clone()
        dets[..., 0] += 1.0
        return dets, n

    return patched(api, "non_max_suppression", moved)


def step_unchanged():
    """Each rollout step hands back the image it got."""
    from adaptiveisp_tpu_torch.policy.agent import Agent

    orig = Agent.forward

    def same(self, x, *a, **k):
        out = orig(self, x, *a, **k)
        return (x,) + tuple(out[1:])

    return patched(Agent, "forward", same)


# --------------------------------------------------------------- training


def optimizer_skipped():
    """The step returns its state unchanged: no update is applied."""
    from adaptiveisp_tpu_torch.train import optim

    return patched(optim.ClipAdam, "step", lambda self, closure=None: None)


def half_batch_loss(step_module):
    """Half of the batch left out of the detector loss of ``step_module``'s
    train step, the mean over the rest taken in its place."""
    orig = step_module.per_image_loss_batch

    def half(*a, **k):
        loss, comps = orig(*a, **k)
        n = loss.shape[0] // 2
        return torch.cat([loss[:n], loss[:n].mean(0, keepdim=True).expand(
            loss.shape[0] - n, *loss.shape[1:])]), comps

    return patched(step_module, "per_image_loss_batch", half)


def train_half_batch():
    """:func:`half_batch_loss` in the program's train step."""
    from adaptiveisp_tpu_torch.train import step

    return half_batch_loss(step)


def critic_skipped():
    """The critic's optimizer never steps: its update is left out."""
    from adaptiveisp_tpu_torch.train.trainer import Trainer

    orig = Trainer.__init__

    def init(self, *a, **k):
        orig(self, *a, **k)
        self.state.value_opt.step = lambda closure=None: None

    return patched(Trainer, "__init__", init)


def writeback_stale():
    """The pool writes back each kept slot's own image, un-retouched, and
    leaves its cached loss as it was."""
    from adaptiveisp_tpu_torch.data.replay_device import DeviceReplayMemory

    orig = DeviceReplayMemory.replace

    def stale(self, idx, retouch, new_states, diverged=False,
              retouch_loss=None):
        slots = torch.as_tensor(idx, dtype=torch.long,
                                device=self.images.device)
        return orig(self, idx, self.images.index_select(0, slots),
                    new_states, diverged=diverged, retouch_loss=None)

    return patched(DeviceReplayMemory, "replace", stale)


def state_unwritten():
    """The pool writes back each kept slot's image and loss and leaves its
    state as it was."""
    from adaptiveisp_tpu_torch.data.replay_device import DeviceReplayMemory

    orig = DeviceReplayMemory.replace

    def unwritten(self, idx, retouch, new_states, diverged=False,
                  retouch_loss=None):
        return orig(self, idx, retouch, self.states[idx].copy(),
                    diverged=diverged, retouch_loss=retouch_loss)

    return patched(DeviceReplayMemory, "replace", unwritten)


INFER = {"half_batch": half_batch, "answer_altered": answer_altered,
         "step_unchanged": step_unchanged}
TRAIN = {"optimizer_skipped": optimizer_skipped,
         "half_batch": train_half_batch, "critic_skipped": critic_skipped,
         "writeback_stale": writeback_stale,
         "state_unwritten": state_unwritten}
