"""The port's device-time observability against the JAX package's:
``component_breakdown`` on JAX's synthetic op table, ``trace_op_table`` on
a hermetic synthetic Chrome trace (a backward kernel lands in its forward
operation's scope), ``utilization`` and ``cost_of`` against JAX's, the peak
table off the card, and ``trace`` / ``profile_fn`` on the CPU."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import record_function

from adaptiveisp_tpu.obs import roofline as jroof
from adaptiveisp_tpu.obs import trace as jtrace
from adaptiveisp_tpu_torch.obs import profile as tprofile
from adaptiveisp_tpu_torch.obs import roofline as troof
from adaptiveisp_tpu_torch.obs import trace as ttrace
from torch_suite import cheap_xla, one_torch_thread  # noqa: F401


def _jax_table(scale):
    """The op table JAX's ``xplane_op_table`` builds from the synthetic
    XSpace of ``tests/test_native_and_aux.py`` (two occurrences of each
    op), durations times ``scale``."""
    ops = [("fusion.1", "jit(step)/agent_fwd/conv", 7000, 100, 50),
           ("fusion.2", "jit(step)/transpose(jvp(step))/agent_fwd/conv",
            2000, 40, 10),
           ("fusion.3", "jit(step)/value_net/dot", 1000, 10, 5),
           ("fusion.4", "jit(step)/optimizer/add", 500, 0, 20),
           ("copy.5", "jit(step)/copy", 300, 0, 8)]
    return [{"name": n, "tf_op": t, "category": "", "duration_ps":
             2 * d * scale, "flops": f, "bytes": b, "count": 2}
            for n, t, d, f, b in ops]


@pytest.mark.parametrize("scale", [1, 10 ** 6])
def test_component_breakdown_equals_jax(scale):
    table = _jax_table(scale)
    assert ttrace.component_breakdown(table) == \
        jtrace.component_breakdown(table)
    comps = {"fwd": ("agent_fwd",), "rest": ("value_net", "optimizer")}
    assert ttrace.component_breakdown(table, comps) == \
        jtrace.component_breakdown(table, comps)
    assert ttrace.TRAIN_STEP_COMPONENTS == jtrace.TRAIN_STEP_COMPONENTS


def _x(cat, name, pid, tid, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def _synthetic_trace():
    """A step: conv under ``agent_fwd`` and mm under ``value_net`` on the
    main thread (10), a forward op of the same sequence number on a second
    thread (30, under ``yolo_input``), their backward operations on the
    engine's thread (20, no scope), a fill outside every scope, and one
    kernel for each launch on the device."""
    main, other, bwd, dev = 10, 30, 20, 7
    ev = [
        _x("user_annotation", "agent_fwd", 1, main, 0, 100),
        _x("cpu_op", "aten::conv2d", 1, main, 10, 50,
           **{"Sequence number": 5, "Fwd thread id": 0, "flops": 1000}),
        _x("cpu_op", "aten::convolution", 1, main, 12, 40),
        _x("cuda_runtime", "cudaLaunchKernel", 1, main, 20, 5,
           correlation=100),
        _x("user_annotation", "yolo_input", 1, other, 50, 40),
        _x("cpu_op", "aten::add", 1, other, 55, 20,
           **{"Sequence number": 5, "Fwd thread id": 0}),
        _x("cuda_runtime", "cudaLaunchKernel", 1, other, 60, 5,
           correlation=105),
        _x("user_annotation", "value_net", 1, main, 200, 50),
        _x("cpu_op", "aten::mm", 1, main, 210, 20,
           **{"Sequence number": 6, "Fwd thread id": 0, "flops": 64}),
        _x("cuda_runtime", "cudaLaunchKernel", 1, main, 215, 5,
           correlation=101),
        _x("cpu_op", "autograd::engine::evaluate_function: "
           "ConvolutionBackward0", 1, bwd, 300, 60,
           **{"Sequence number": 5, "Fwd thread id": 1}),
        _x("cpu_op", "aten::convolution_backward", 1, bwd, 305, 40),
        _x("cuda_runtime", "cudaLaunchKernel", 1, bwd, 310, 5,
           correlation=102),
        _x("cpu_op", "MmBackward0", 1, bwd, 400, 30,
           **{"Sequence number": 6, "Fwd thread id": 1}),
        _x("cpu_op", "aten::mm", 1, bwd, 405, 20),
        _x("cuda_runtime", "cudaLaunchKernel", 1, bwd, 410, 5,
           correlation=103),
        _x("cpu_op", "aten::fill_", 1, main, 500, 5),
        _x("cuda_runtime", "cudaLaunchKernel", 1, main, 501, 2,
           correlation=104),
    ]
    for corr, name, ts, dur in ((100, "conv_fprop", 30, 30),
                                (105, "add_kernel", 70, 4),
                                (101, "gemm", 230, 10),
                                (102, "conv_dgrad", 320, 60),
                                (103, "gemm", 420, 12),
                                (104, "fill_kernel", 505, 3)):
        ev.append(_x("kernel", name, 0, dev, ts, dur, correlation=corr))
    ev.append({"ph": "s", "id": 100, "pid": 1, "tid": main, "ts": 20})
    return {"traceEvents": ev}


def test_trace_op_table_puts_backward_in_forward_scope(tmp_path):
    (tmp_path / "run").mkdir()
    (tmp_path / "run" / "trace.json").write_text(
        json.dumps(_synthetic_trace()))
    rows = {(r["name"], r["tf_op"]): r
            for r in ttrace.trace_op_table(str(tmp_path))}
    assert set(rows) == {("conv_fprop", "agent_fwd"),
                         ("conv_dgrad", "agent_fwd"),
                         ("add_kernel", "yolo_input"),
                         ("gemm", "value_net"), ("fill_kernel", "")}
    gemm = rows[("gemm", "value_net")]
    assert gemm["count"] == 2 and gemm["duration_ps"] == 22 * 10 ** 6
    assert gemm["flops"] == 32.0   # 64 FLOPs over its two occurrences
    assert rows[("conv_fprop", "agent_fwd")]["flops"] == 1000.0
    comps = ttrace.component_breakdown(list(rows.values()))
    assert comps["agent_fwd"]["ms"] == 0.09
    assert comps["value_net"]["ms"] == 0.022
    assert comps["yolo_input"]["ms"] == 0.004
    assert comps["other"]["ms"] == 0.003


def test_utilization_and_cost_of_equal_jax(monkeypatch):
    jp = jroof.Peaks("H100 SXM5", 9.89e14, 3.35e12)
    tp = troof.Peaks("H100 SXM5", 9.89e14, 3.35e12)
    monkeypatch.setattr(jroof, "device_peaks", lambda device=None: jp)
    monkeypatch.setattr(troof, "device_peaks", lambda device=None: tp)
    for args in ((0.01, 1e12, 1e10), (0.002, 5e9, 4e9), (0.5, 0.0, 1e9),
                 (0.0, 1e9, 1e9)):
        assert troof.utilization(*args) == jroof.utilization(*args)
    a = np.random.RandomState(0).rand(48, 96).astype(np.float32)
    b = np.random.RandomState(1).rand(96, 40).astype(np.float32)
    want = jroof.cost_of(lambda x, y: x @ y, jnp.asarray(a), jnp.asarray(b))
    got = troof.cost_of(torch.matmul, torch.from_numpy(a),
                        torch.from_numpy(b))
    assert got["flops"] == want["flops"] == 2 * 48 * 96 * 40
    assert got["bytes"] == (48 * 96 + 96 * 40 + 48 * 40) * 4


def test_device_peaks_off_the_card():
    assert troof.device_peaks() is None
    assert troof.device_peaks("cpu") is None
    assert troof.utilization(0.01, 1e12, 1e10) == {}


def test_trace_on_the_cpu_feeds_the_op_table(tmp_path):
    """``trace`` writes a Chrome trace that ``trace_op_table`` reads; on the
    CPU its rows are the outermost operations, and the backward's are
    given their forward operation's scope."""
    lin, head = torch.nn.Linear(16, 16), torch.nn.Linear(16, 2)
    x = torch.randn(8, 16)
    with tprofile.trace(str(tmp_path)):
        with record_function("agent_fwd"):
            y = lin(x).relu()
        with record_function("value_net"):
            loss = head(y).square().mean()
        loss.backward()
    assert ttrace.find_trace_files(str(tmp_path))
    rows = ttrace.trace_op_table(str(tmp_path), categories=("cpu_op",))
    scopes = {(r["name"], r["tf_op"]) for r in rows}
    assert ("aten::linear", "agent_fwd") in scopes
    assert ("autograd::engine::evaluate_function: AddmmBackward0",
            "agent_fwd") in scopes
    assert ("autograd::engine::evaluate_function: AddmmBackward0",
            "value_net") in scopes
    fwd = [r for r in rows if r["name"] == "aten::linear"
           and r["tf_op"] == "agent_fwd"]
    assert fwd[0]["flops"] == 2 * 8 * 16 * 16
    cost = tprofile.profile_fn(lin, x)
    assert cost["flops"] == 2 * 8 * 16 * 16
    assert cost["argument_bytes"] == cost["output_bytes"] == 8 * 16 * 4
    assert cost["bytes_accessed"] > 0 and "temp_bytes" not in cost
