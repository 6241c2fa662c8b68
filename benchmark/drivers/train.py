"""RL training of the agent: ``Trainer`` as ``train_isp`` builds it (device
replay pool, cached reward, the reward detector in the configuration's
precision) on a seeded PNG folder under ``TMPDIR``, with ``Trainer.train``
driven through the window.

Set-up builds the trainer and drives it through its first steps (the
traffic's ``check_steps``), recording each batch the pool hands to the
step; the window then continues the same trainer.  The reference follows
those first steps afterwards.  Every iteration of the window is counted;
the window runs from the first iteration's start to the last one's end.
"""

from __future__ import annotations

import gc
import shutil
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import devices, host, precision
from benchmark.harness import BENCH_DIR, Outcome, load_json
from benchmark.reference import compare
from benchmark.reference import models as ref
from benchmark.reference import training as ref_train
from benchmark.reference.detect.model import initialize_detect_biases
from benchmark.roofline import devicetrace
from benchmark.traffic.dataset import data_root, write_dataset
from benchmark.weights import seed_of, shapes_of, spread_state

# the train step's record_function scopes that the per-layer readers read
COMPONENTS = {"agent_fwd": ("agent_fwd",), "yolo_retouch": ("yolo_retouch",),
              "value_net": ("value_net",), "optimizer": ("optimizer",)}


class StopWindow(Exception):
    pass


def weights(cell, device) -> Dict[str, Dict]:
    """The agent's, critic's and reward detector's state dicts, drawn from
    the configuration's ``weights_seed`` (one model for every run).  The
    detector's head gets the traffic's ``detector_prior``
    (Ultralytics' prior of a fresh detector's objectness and class biases,
    at the training image size), so that its clipped loss, and with it the
    reward's gradient, is not saturated at the clip."""
    cfg_file, tr = cell.config, cell.traffic
    seed = int(cfg_file["weights_seed"])
    det = spread_state(shapes_of(ref.detector(cfg_file)),
                       seed_of(seed, "detector"), device)
    if tr.get("detector_prior"):
        det = initialize_detect_biases(det, ref.spec(cfg_file),
                                       int(tr["imgsz"]))
    return {"agent": spread_state(shapes_of(ref.agent(cfg_file)),
                                  seed_of(seed, "agent"), device),
            "value": spread_state(shapes_of(ref_train.value(cfg_file)),
                                  seed_of(seed, "value"), device),
            "detector": det}


def trainer_settings(cell, seed: int):
    """(Config overrides, TrainConfig fields) of the trainer."""
    tr = cell.traffic
    return (dict(tr["config_overrides"]),
            {"batch_size": int(tr["batch"]), "imgsz": int(tr["imgsz"]),
             "seed": seed_of(seed, "trainer") % 2 ** 31})


def build_trainer(cell, seed: int, w: Dict, folder: str, device):
    from adaptiveisp_tpu_torch.config import Config, TrainConfig
    from adaptiveisp_tpu_torch.detect.spec import load_spec
    from adaptiveisp_tpu_torch.train.trainer import Trainer

    cfg_file, tr = cell.config, cell.traffic
    overrides, tcfg_kw = trainer_settings(cell, seed)
    fields = dict(cfg_file["agent_config"], **overrides)
    cfg = Config(**{k: tuple(v) if isinstance(v, list) else v
                    for k, v in fields.items()})
    return Trainer(
        cfg, TrainConfig(**tcfg_kw), folder,
        save_dir=str(data_root(cell.name) / "run"),
        yolo_state_dict=w["detector"], data_source=tr["source"], log=False,
        yolo_spec=load_spec(cfg_file["detector"]["spec"]),
        yolo_dtype=cfg_file["precision"]["train"]["detector"],
        device_replay=True, cached_reward=bool(tr["cached_reward"]),
        device=device, agent_state_dict=w["agent"],
        value_state_dict=w["value"])


class Recorder:
    """Watches the trainer's first ``n`` steps through public seams: the
    step (wrapped: the batch it was handed, the dropout generator's state,
    progress, losses, sampled actions), the pool's ``sample`` (the slots,
    their files and the noise) and ``replace`` (each sampled slot's image,
    state and cached loss once written back), and the parameters' gradients
    of the first step as autograd accumulates them (post-accumulate hooks).
    While ``selections`` is a list it also keeps every step's
    selections."""

    def __init__(self, trainer, n: int):
        self.n, self.pool = n, trainer.device_replay
        self.step, self.sample, self.replace = (
            trainer.train_step, self.pool.sample, self.pool.replace)
        self.steps: List[Dict] = []
        self.grads: Dict = {}
        self.selections = None
        self._open = False
        trainer.train_step = self._step
        self.pool.sample, self.pool.replace = self._sample, self._replace
        self._hooks = [p.register_post_accumulate_grad_hook(
            self._grab(k)) for k, p in ref_train.leaves(trainer.state).items()]

    def _grab(self, name):
        def hook(p):
            if self._open and len(self.steps) == 1:
                self.grads[name] = p.grad.detach().clone()
        return hook

    def _sample(self, batch_size):
        out = self.sample(batch_size)
        self._open = len(self.steps) < self.n
        if self._open:
            idx, _, states, _, paths, _, z = out
            self.steps.append({"slots": np.asarray(idx).copy(),
                               "paths": list(paths), "z": z.copy()})
        return out

    def _step(self, state, batch, generator, progress, mark=None):
        if self._open:
            self.steps[-1].update(
                batch=tuple(t.clone() for t in batch),
                gen_state=generator.get_state(), progress=progress)
        out = self.step(state, batch, generator, progress, mark)
        if self._open:
            self.steps[-1].update(
                losses={k: float(out.metrics[k])
                        for k in ("agent_loss", "value_loss")},
                actions=out.metrics["selected_filter"].clone())
            if len(self.steps) == 1:
                for h in self._hooks:
                    h.remove()
                if not self.grads:
                    raise RuntimeError("the first step accumulated no "
                                       "parameter gradient to compare")
        if self.selections is not None:
            self.selections.append(out.metrics["selected_filter"])
        return out

    def _replace(self, idx, *args, **kwargs):
        out = self.replace(idx, *args, **kwargs)
        if self._open:
            slots = torch.as_tensor(np.asarray(idx, np.int64),
                                    device=self.pool.images.device)
            self.steps[-1]["written"] = (
                self.pool.images.index_select(0, slots),
                self.pool.states[idx].copy(), self.pool.sampled_loss(idx))
        return out

    def drawn(self) -> List[Dict]:
        """What the program drew, step by step, and the images its pool
        handed each step, for the reference."""
        return [{"slots": s["slots"], "paths": s["paths"], "z": s["z"],
                 "gen_state": s["gen_state"], "progress": s["progress"],
                 "actions": s["actions"], "t_max": s["batch"][3].shape[1],
                 "images": s["batch"][0]}
                for s in self.steps]

    def served(self, state) -> Dict:
        """The program's side of the check (:func:`compare.train_numbers`):
        handed batches, write-backs, losses, actions, gradients and the
        parameters now."""
        grads = {k: self.grads.get(k, torch.zeros_like(p))
                 for k, p in ref_train.leaves(state).items()}
        return {"losses": [s["losses"] for s in self.steps],
                "selected": [s["actions"] for s in self.steps],
                "handed": [(b[0], b[2], b[5], b[3], b[4]) for b in
                           (s["batch"] for s in self.steps)],
                "written": [s["written"] for s in self.steps],
                "grads": grads,
                "params": {k: p.detach().clone() for k, p in
                           ref_train.leaves(state).items()}}


class Window:
    """The trainer's ``mark`` hook: ends the window at the first iteration
    start past ``seconds``; with ``spans`` it synchronizes at every mark
    and keeps each iteration's mark times."""

    def __init__(self, seconds: float, device, spans: bool):
        self.seconds, self.device = seconds, device
        self.t0 = self.t_end = None
        self.iters = 0
        self.durations: List[float] = []
        self.spans = [] if spans else None

    def __call__(self, name: str):
        if self.spans is not None:
            devices.sync(self.device)
        now = time.perf_counter()
        if name == "start":
            if self.t0 is None:
                self.t0 = now
            elif now - self.t0 >= self.seconds:
                raise StopWindow
            if self.spans is not None:
                self.spans.append({})
        if self.spans is not None:
            self.spans[-1][name] = now
        if name == "end":
            self.iters += 1
            if self.t_end is not None:
                self.durations.append(now - self.t_end)
            self.t_end = now


def warm_pool_sizes(trainer, device) -> int:
    """Runs the pool's seeding loss (the reward detector on freshly loaded
    slots, in chunks of at most the feeder's batch) once at every size that
    a refresh can hand it, so that no size meets the detector for the first
    time inside the window; returns the number of sizes.  The loss is pure:
    it reads the pool's images and labels and writes nothing."""
    pool = trainer.device_replay
    if getattr(pool, "loss_fn", None) is None:
        return 0
    n = min(int(pool.feeder.batch_size), int(pool.images.shape[0]))
    labels = [m["label"] for m in pool.meta[:n]]
    for k in range(1, n + 1):
        pool.loss_fn(pool.images[:k], labels[:k])
    devices.sync(device)
    return n


def interval_ms(spans, a: str, b: str) -> List[float]:
    return [(s[b] - s[a]) * 1e3 for s in spans if a in s and b in s]


def run(cell, seed: int, seconds: float, trace: bool, started: float,
        device) -> Outcome:
    root = data_root(cell.name)
    try:
        return _run(cell, seed, seconds, trace, started, device, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def first_steps(cell, seed: int, device, root, phases=None):
    """The dataset, the trainer, and the trainer driven through its first
    ``check_steps`` with each step recorded: (trainer, recorder, the
    served side of the check)."""
    tr = cell.traffic
    precision.program(cell.config["precision"]["train"])
    phases = phases or devices.Phases(time.perf_counter())
    folder = write_dataset(root / "data", int(tr["dataset_images"]),
                           int(tr["frame"][0]), int(tr["frame"][1]),
                           seed_of(seed, "scenes"), device, tr["scene"])
    phases.mark("dataset")
    w = weights(cell, device)
    phases.mark("weights")
    trainer = build_trainer(cell, seed, w, str(folder), device)
    del w
    gc.collect()
    devices.reset_peak(device)
    phases.mark("trainer")
    rec = Recorder(trainer, int(tr["check_steps"]))
    trainer.train(max_steps=int(tr["check_steps"]) - 1)
    phases.mark("first_steps")
    phases.report()
    return trainer, rec, rec.served(trainer.state)


def _run(cell, seed, seconds, trace, started, device, root) -> Outcome:
    tr = cell.traffic
    trainer, rec, prog = first_steps(cell, seed, device, root,
                                     devices.Phases(started))

    sizes = warm_pool_sizes(trainer, device)
    print(f"warm-up: the pool's seeding loss at {sizes} sizes",
          file=sys.stderr)
    window = Window(seconds, device, spans=trace)
    waits = host.Timed(trainer.device_replay.feeder, "next_batch")
    seeding = (host.Timed(trainer.device_replay, "loss_fn")
               if trainer.device_replay.loss_fn is not None else None)
    with host.Watch(tr.get("host")) as watch:
        try:
            trainer.train(max_steps=10 ** 9, mark=window)
        except StopWindow:
            pass
    watch.report()
    print("feeder waits in window: calls=%d seconds=%.4f" % waits.reading(),
          file=sys.stderr)
    if seeding is not None:
        print("pool seeding in window: calls=%d seconds=%.4f"
              % seeding.reading(), file=sys.stderr)
    setup_s = window.t0 - started
    window_s = window.t_end - window.t0
    peak = devices.peak_bytes(device)
    batch = int(tr["batch"])
    dev_info = {"platform": "gpu", "kind": devices.name(device), "count": 1,
                "memory_peak_bytes": peak}
    layer, breakdown = {}, None
    if trace:
        layer, breakdown = traced_iterations(cell, trainer, rec, device)
        dev_info["busy_s"] = layer["trace"]["busy_s"]
        dev_info["window_s"] = layer["trace"]["window_s"]
        spans = window.spans
        layer.update(
            pool_ms=[a + b for a, b in zip(
                interval_ms(spans, "start", "sample"),
                interval_ms(spans, "optimizer", "writeback"))],
            optimizer_ms=interval_ms(spans, "backward", "optimizer"),
            units=window.iters, window_s=window_s)
    counters = {"refreshes": trainer.device_replay.refreshes,
                "fresh_images": trainer.device_replay.fresh_images,
                "divergences": trainer.divergence_count}
    print("trainer counters " + " ".join(f"{k}={v}"
                                         for k, v in counters.items()),
          file=sys.stderr)
    devices.spread_report("iteration", window.durations)
    trainer.close()
    del trainer
    gc.collect()
    devices.free(device)

    numbers, flops = reference_numbers(cell, seed, rec.drawn(), prog,
                                       device, count_flops=trace)
    if trace:
        layer["flops_by_dtype"] = flops
    print("reference numbers " + " ".join(
        f"{k}={v}" for k, v in numbers.items()), file=sys.stderr)
    checks = compare.to_checks(numbers, limits_of(cell.name))
    images = batch * window.iters
    if trace:
        layer["images"] = images
    e2e = {"train_peak_memory_gb": peak / 1e9, "setup_s": setup_s}
    return Outcome(e2e, images, 0, checks, dev_info, layer, breakdown)


def limits_of(cell_name: str) -> Dict[str, float]:
    return load_json(BENCH_DIR / "limits" / f"{cell_name}.json")["limits"]


def reference_numbers(cell, seed, drawn, prog, device, count_flops=False,
                      stand_in=None):
    """The reference's first steps, from what the program drew, against
    the served ones, or against ``stand_in`` (a context manager under which
    the reference takes the program's place: the control, a planted
    fault); model FLOPs of one step by dtype when ``count_flops``."""
    w = weights(cell, device)
    initial = {f"agent.{k}": v for k, v in w["agent"].items()}
    initial.update({f"value.{k}": v for k, v in w["value"].items()})
    overrides, tcfg_kw = trainer_settings(cell, seed)
    with precision.reference():
        ref_out = ref_train.follow(cell.config, tcfg_kw, w, drawn, device,
                                   overrides)
    if stand_in is not None:
        with stand_in():
            prog = ref_train.follow(cell.config, tcfg_kw, w, drawn, device,
                                    overrides)
    numbers = compare.train_numbers(prog, ref_out, initial)
    flops = None
    if count_flops:
        flops = step_flops(cell, w, drawn[:1], tcfg_kw, overrides, device)
    return numbers, flops


def step_flops(cell, w, drawn, tcfg_kw, overrides, device):
    """FLOPs of one reference step: the detector's in its training dtype,
    the rest in float32."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with precision.reference(), counter:
        ref_train.follow(cell.config, tcfg_kw, w, drawn, device, overrides)
    by_module = counter.get_flop_counts()
    total = float(counter.get_total_flops())
    det = float(sum(by_module.get("DetectionModel", {}).values()))
    return {cell.config["precision"]["train"]["detector"]: det,
            "float32": total - det}


def traced_iterations(cell, trainer, rec, device):
    """``trace_iters`` more iterations under the profiler, after the
    window; returns what the per-layer readers read and the breakdown."""
    tr = cell.traffic
    n = int(tr["trace_iters"])
    denoise = ref.filter_index(cell.config, "denoise")
    size, batch = int(tr["imgsz"]), int(tr["batch"])
    rec.selections = []
    start = int(trainer.state.step)
    with devicetrace.Recorder(cell.name, COMPONENTS) as prof:
        trainer.train(max_steps=start + n - 1)
    summary = prof.summary()
    nlm = []
    if denoise >= 0:
        nlm = [(int((s == denoise).sum()), batch, size, size)
               for s in rec.selections]
    rec.selections = None
    layer = {"trace": summary, "traced_images": n * batch,
             "traced_iters": n, "nlm_fwd_launches": nlm,
             "nlm_bwd_launches": nlm}
    return layer, devicetrace.breakdown(summary)
