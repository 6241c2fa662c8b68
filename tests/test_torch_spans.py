"""The port's spans and host-read counters (``obs.profile.span`` /
``count``) on the CPU at tiny shapes: off without a profiler; under one, a
served batch (``process_with_trace`` and ``Detector.detect``) and one
``Trainer`` iteration give a Chrome trace whose spans nest as the layers
do, the counters count the rollout's stop reads and NMS's flag reads,
``trace()`` writes ``counts.json``, and the train step's component buckets
are those its five scopes alone give.  On the card (marked ``cuda``), the
counters against ``torch.cuda.set_sync_debug_mode("warn")``.  Then the
benchmark's readers of the spans and counters on hand-built layers.
"""

import contextlib
import json
import os
import warnings

import numpy as np
import pytest
import torch
from PIL import Image

from adaptiveisp_tpu_torch import api
from adaptiveisp_tpu_torch.config import TrainConfig
from adaptiveisp_tpu_torch.configs.config_fast_filters import cfg as FAST
from adaptiveisp_tpu_torch.obs import profile
from adaptiveisp_tpu_torch.obs import trace as ttrace
from adaptiveisp_tpu_torch.ops.bank import short_names
from adaptiveisp_tpu_torch.train.trainer import Trainer
from benchmark import harness
from test_torch_nlm import one_torch_thread  # noqa: F401

MINI_SPEC = {   # tests/test_torch_trainer.py's
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
STEPS = 3
NMS = dict(conf_thres=0.001, iou_thres=0.6, multi_label=True, max_det=300)
# the spans this port adds around the step's scopes, by prefix
NEW_SPANS = ("trainer.", "train_step", "rollout", "agent.", "render.",
             "pool.", "feeder.", "detect", "nms.")


def _spans(trace_dir):
    """[(name, name of the innermost span around it or None)] of every
    span on the main thread, and the trace's events."""
    with open(trace_dir / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    anns = [e for e in events if e.get("cat") == "user_annotation"
            and e.get("ph") == "X"]
    main = max({(e["pid"], e["tid"]) for e in anns},
               key=lambda k: sum(1 for e in anns if (e["pid"], e["tid"])
                                 == k))
    for e in anns:
        e["ts"], e["dur"] = float(e["ts"]), float(e["dur"])
    th = ttrace._Thread([e for e in anns
                         if (e["pid"], e["tid"]) == main])
    out = []
    for e in th.events:
        chain = th.chain_of(e)
        out.append((e["name"], chain[-2]["name"] if len(chain) > 1
                    else None))
    return out


@contextlib.contextmanager
def _profiled(out):
    """``torch.profiler`` on the CPU over the block, ``COUNTS`` emptied
    first, the Chrome trace written to ``out/trace.json`` unless ``out`` is
    None (a lighter ``obs.profile.trace``: no shapes or FLOPs)."""
    profile.COUNTS.clear()
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    with prof:
        yield
    if out is not None:
        out.mkdir(exist_ok=True)
        prof.export_chrome_trace(str(out / "trace.json"))


def _parents(spans, name):
    return {p for n, p in spans if n == name}


def _no_profiler():
    assert not torch.autograd._profiler_enabled()


def test_span_and_count_are_no_ops_without_a_profiler():
    _no_profiler()
    profile.COUNTS.clear()
    a, b = profile.span("rollout"), profile.span("detect.nms")
    assert a is b and type(a).__name__ == "_NoSpan"
    with a as inner:
        assert inner is a
        profile.count("host_read.rollout")
        profile.count("host_read.nms", 3)
    assert profile.COUNTS == {}
    with pytest.raises(ValueError):   # exceptions pass through
        with profile.span("x"):
            raise ValueError


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """One tiny served batch under the profiler."""
    torch.manual_seed(0)
    isp = api.load_adaptive_isp(cfg=FAST, steps=STEPS, device="cpu")
    det = api.load_detector(spec=MINI_SPEC, device="cpu")
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    out = tmp_path_factory.mktemp("served_trace")
    with _profiled(out):
        res = isp.process_with_trace(x, seed=3, record_steps=False)
        det.detect(res.image, **NMS)
    return {"spans": _spans(out), "counts": dict(profile.COUNTS)}


def test_served_spans_nest_as_the_layers(served):
    spans = served["spans"]
    assert _parents(spans, "rollout") == {None}
    assert _parents(spans, "detect") == {None}
    for child, parent in [("rollout.step", "rollout"),
                          ("rollout.stop_read", "rollout.step"),
                          ("agent.nets", "rollout.step"),
                          ("agent.render", "rollout.step"),
                          ("detect.forward", "detect"),
                          ("detect.decode", "detect"),
                          ("detect.nms", "detect"),
                          ("nms.block", "detect.nms")]:
        assert _parents(spans, child) == {parent}, child
    for name in short_names(FAST):
        assert _parents(spans, "render." + name) == {"agent.render"}, name
    names = [n for n, _ in spans]
    assert names.count("rollout.step") == STEPS
    assert names.count("render." + short_names(FAST)[0]) == STEPS


def test_served_counters(served):
    counts = served["counts"]
    assert counts["host_read.rollout"] == STEPS   # one stop read a step
    assert counts["host_read.nms"] >= 1
    assert counts["host_read.upload.rollout"] == 2   # noises and states


def test_trace_zeroes_the_counts_and_writes_them(tmp_path):
    profile.COUNTS["stale"] = 5
    with profile.trace(str(tmp_path)):
        profile.count("host_read.nms", 2)
    with open(tmp_path / "counts.json") as f:
        assert json.load(f) == {"host_read.nms": 2}
    profile.count("host_read.nms")   # no profiler: nothing counted
    assert profile.COUNTS == {"host_read.nms": 2}


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


def _tiny_trainer(root, device, save_model_freq):
    """A tiny port ``Trainer`` after iteration 0, its next iteration due to
    validate and to refresh every sampled slot at its write-back
    (trajectories of one step, none kept) from the feeder's next batch."""
    cfg = FAST.replace(replay_memory_size=8, val_freq=1,
                       save_model_freq=save_model_freq, print_freq=1,
                       summary_freq=1, dropout_keep_prob=1.0,
                       maximum_trajectory_length=1,
                       over_length_keep_prob=0.0)
    data = _toy_set(root / "data")
    tr = Trainer(cfg, TrainConfig(batch_size=2, epochs=1, imgsz=64),
                 data, val_path=data, save_dir=str(root / "run"),
                 yolo_spec=MINI_SPEC, t_max=8, log=False,
                 yolo_dtype="float32", device_replay=True,
                 cached_reward=True, device=device)
    tr.train(max_steps=0)
    tr.device_replay._fresh_queue = []   # the refresh waits on the feeder
    return tr


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Iteration 1 of :func:`_tiny_trainer` under ``torch.profiler``, a
    checkpoint due too."""
    root = tmp_path_factory.mktemp("spans_trainer")
    tr = _tiny_trainer(root, "cpu", save_model_freq=1)
    try:
        out = root / "trace"
        with _profiled(out):
            tr.train(max_steps=1)
        yield {"dir": out, "spans": _spans(out),
               "counts": dict(profile.COUNTS)}
    finally:
        tr.close()


def test_trainer_spans_nest_as_the_layers(trained):
    spans = trained["spans"]
    assert _parents(spans, "trainer.iteration") == {None}
    for child, parent in [
            ("pool.sample", "trainer.iteration"),
            ("trainer.upload", "trainer.iteration"),
            ("train_step", "trainer.iteration"),
            ("trainer.fetch", "trainer.iteration"),
            ("pool.writeback", "trainer.iteration"),
            ("pool.refresh", "pool.writeback"),
            ("feeder.wait", "pool.refresh"),
            ("pool.seed_loss", "pool.refresh"),
            ("trainer.log", "trainer.iteration"),
            ("trainer.validate", "trainer.iteration"),
            ("trainer.checkpoint", "trainer.iteration"),
            ("agent_fwd", "train_step"),
            ("yolo_retouch", "train_step"),
            ("value_net", "train_step"),
            ("optimizer", "train_step"),
            ("rollout", "trainer.validate")]:
        assert _parents(spans, child) == {parent}, child
    for name in ("agent.nets", "agent.render"):   # the step; validation
        assert _parents(spans, name) == {"agent_fwd", "rollout.step"}
    counts = trained["counts"]
    assert counts["host_read.trainer"] == 1 + 3 * 2   # fetch; validation
    assert counts["host_read.upload.pool"] >= 3


def _bucket(path):
    row = {"tf_op": path, "duration_ps": 10 ** 9, "flops": 0.0, "bytes": 0,
           "count": 1}
    out = ttrace.component_breakdown([row])
    return next(k for k, v in out.items() if k != "total" and v["ms"] > 0)


def test_new_spans_keep_the_step_components(trained):
    table = ttrace.trace_op_table(str(trained["dir"]),
                                  categories=("cpu_op",))
    paths = {r["tf_op"] for r in table}
    assert any("agent_fwd/agent.nets" in p for p in paths)
    assert any("trainer.iteration/train_step/yolo_retouch" in p
               for p in paths)
    seen = set()
    for p in paths:
        old = "/".join(s for s in p.split("/") if s
                       and not s.startswith(NEW_SPANS))
        assert _bucket(p) == _bucket(old), p
        seen.add(_bucket(p))
    assert {"agent_fwd", "yolo_retouch", "value_net", "optimizer",
            "other"} <= seen


def test_the_step_scopes_go_through_span():
    """The five scopes of ``train/step.py`` are spans: no profiler, no
    ``record_function``."""
    import adaptiveisp_tpu_torch.train.step as step

    assert step.span is profile.span
    assert not hasattr(step, "record_function")


def _synchronizing_calls(fn):
    """(synchronizing CUDA calls that the program's own code makes in
    ``fn()``, the sum of the ``host_read.*`` counters over it), with the
    profiler recording.  A warning is the program's when the frame it is
    raised in is the package's (one raised where no frame of the program
    runs, as a tensor's release, is not)."""
    package = os.path.dirname(api.__file__) + os.sep
    with warnings.catch_warnings(record=True) as seen, _profiled(None):
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchronizing" in str(w.message)
                and w.filename.startswith(package) for w in seen)
    return syncs, sum(n for k, n in profile.COUNTS.items()
                      if k.startswith("host_read."))


@pytest.mark.cuda
def test_the_counters_count_every_synchronizing_call(tmp_path):
    """On the card, every call of a served batch and of a trainer iteration
    (a refresh, its seeding loss and validation in it) at which the host
    waits for the stream is a ``host_read`` count."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the counters are held against the "
                    "card's synchronizing calls")
    torch.manual_seed(0)
    isp = api.load_adaptive_isp(cfg=FAST, steps=STEPS, device="cuda")
    det = api.load_detector(spec=MINI_SPEC, device="cuda")
    x = torch.rand(2, 64, 64, 3, device="cuda")
    det.detect(isp.process_with_trace(x, seed=2, record_steps=False).image,
               **NMS)
    syncs, counted = _synchronizing_calls(lambda: det.detect(
        isp.process_with_trace(x, seed=3, record_steps=False).image, **NMS))
    assert syncs == counted > 0
    tr = _tiny_trainer(tmp_path, "cuda", save_model_freq=10 ** 9)
    try:
        syncs, counted = _synchronizing_calls(lambda: tr.train(max_steps=1))
    finally:
        tr.close()
    assert syncs == counted > 0


# --------------------------------------------------------------------------- #
# the benchmark's readers
# --------------------------------------------------------------------------- #
INFER_GAPS = [("rollout.step", 0.010), ("agent.nets", 0.002),
              ("render.E", 0.001), ("rollout_x", 5.0), ("detect", 0.004),
              ("nms.block", 0.003), ("detector", 7.0),
              ("host (between operations)", 1.0), ("cudaLaunchKernel", 0.5)]
TRAIN_GAPS = [("trainer.iteration", 0.02), ("pool.seed_loss", 0.01),
              ("feeder.wait", 0.004), ("trainer", 0.006), ("train_step", 1.0),
              ("agent_fwd", 1.0), ("pooling", 3.0),
              ("host (between operations)", 2.0)]


@pytest.mark.parametrize("name,layer,counts,want", [
    ("rollout_host_idle_ms.infer",
     {"trace": {"gaps": INFER_GAPS}, "traced_images": 32, "batch": 16},
     {}, 6.5),
    ("detect_host_idle_ms.infer",
     {"trace": {"gaps": INFER_GAPS}, "traced_images": 32, "batch": 16},
     {}, 3.5),
    ("host_reads_per_batch.infer",
     {"trace": {"gaps": []}, "traced_images": 32, "batch": 16},
     {"host_read.rollout": 10, "host_read.nms": 8,
      "host_read.upload.detect": 12, "launches": 100}, 15.0),
    ("pool_host_idle_ms.train",
     {"trace": {"gaps": TRAIN_GAPS}, "traced_iters": 4}, {}, 10.0),
    ("host_reads_per_iter.train",
     {"trace": {"gaps": []}, "traced_iters": 4},
     {"host_read.trainer": 4, "host_read.upload.pool": 20,
      "host_read.upload.loss": 36, "other": 9}, 15.0),
])
def test_readers(monkeypatch, name, layer, counts, want):
    monkeypatch.setattr(profile, "COUNTS", dict(counts))
    read = harness.metric_reader(name)
    assert read(layer) == pytest.approx(want, rel=1e-12)
    # no traced units
    assert read({}) is None
    assert read(dict(layer, traced_images=0, traced_iters=0)) is None
    # a program without the spans and counters reads nothing
    monkeypatch.delattr(profile, "COUNTS")
    monkeypatch.delattr(profile, "span")
    assert read(layer) is None
