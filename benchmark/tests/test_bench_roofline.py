"""The frozen roofline counts against hand counts."""

import pytest

from benchmark.roofline import kernels, peaks


def test_peaks():
    assert peaks.FLOPS["float32"] == 67e12
    assert peaks.FLOPS["bfloat16"] == 989e12
    assert peaks.HBM_BYTES_PER_S == 3.35e12


def test_nlm_forward_bound_by_hand():
    # one gated-on 1x1 image: 12 bytes read for the on pixel, 16 for
    # every pixel's U and W, 8 for h and the gate; 60 x 13 + 121 x 7 ops
    b = kernels.nlm_bound(1, 1, 1, 1)
    assert b["bytes"] == 12 + 16 + 8
    assert b["ops"] == 60 * 13 + 121 * 7
    # 16 images at 512 px, 5 of them on: bound by operations
    b = kernels.nlm_bound(5, 16, 512, 512)
    px_on = 5 * 512 * 512
    assert b["ops"] == px_on * 1627
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == pytest.approx(px_on * 1627 / 67e12 * 1e3)
    # every image off: only U and W written, bound by bytes
    b = kernels.nlm_bound(0, 16, 512, 512)
    assert b["ops"] == 0 and b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(
        (16 * 512 * 512 * 16 + 16 * 8) / 3.35e12 * 1e3)


def test_nlm_backward_bound_by_hand():
    b = kernels.nlm_bwd_bound(1, 2, 1, 1)
    assert b["bytes"] == 40 + 2 * 12 + 2 * 12
    assert b["ops"] == 60 * 56
    assert b["sfu_ms"] == pytest.approx(60 * 4 / peaks.SFU_OPS_PER_S * 1e3)


def test_pipeline_bound_by_hand():
    b = kernels.pipeline_bound(["exposure", "gamma"], 2, 3, 4, 5)
    px = 2 * 3 * 4
    assert b["bytes"] == px * 24 + 2 * 5 * 4
    assert b["ops"] == px * (3 + 12)
