"""The port's functions called in the JAX package's positional order.

A caller written against the JAX package passes arguments by position;
each test below calls the port exactly so, with every option away from its
default, and holds the result against the JAX package's on the same
inputs: ``letterbox``, ``ISPDataset``, ``BatchFeeder``, ``ReplayMemory``,
``DeviceReplayMemory`` and ``non_max_suppression``.  Images to 1e-6 (each
package resizes with its own build of ``csrc/preprocess.cpp``), labels,
states, noise and slots exactly; NMS boxes to 1e-4 and scores to 1e-6 as
in ``test_torch_detect.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptiveisp_tpu.config import Config as JConfig
from adaptiveisp_tpu.data import datasets as jdatasets
from adaptiveisp_tpu.data.letterbox import letterbox as jletterbox
from adaptiveisp_tpu.data.replay import ReplayMemory as JReplayMemory
from adaptiveisp_tpu.detect.nms import non_max_suppression as jnms
from adaptiveisp_tpu_torch.config import Config
from adaptiveisp_tpu_torch.data import datasets as tdatasets
from adaptiveisp_tpu_torch.data.letterbox import letterbox
from adaptiveisp_tpu_torch.data.replay import ReplayMemory
from adaptiveisp_tpu_torch.detect.nms import non_max_suppression
from test_torch_data import _feeds_equal, _same_record, _toy_set
from test_torch_detect import _decoded
from torch_suite import cheap_xla, one_torch_thread  # noqa: F401

# (color, auto, scale_fill, scaleup, stride) after (im, new_shape)
LETTERBOX_ARGS = [((0.5, 0.25, 1.0), False, False, True, 32),
                  ((0, 0, 0), True, False, True, 32),
                  ((0.2, 0.2, 0.2), True, False, False, 16),
                  ((0.1, 0.1, 0.1), False, True, True, 32),
                  ((114 / 255,) * 3, False, False, False, 32)]
# ISPDataset after path: img_size, source, high_res, augment, add_noise,
# brightness_range, noise_level, use_linear, limit, train, cache_labels,
# cache_images, cache_threads, seed, decode_threads
DATASET_ARGS = (96, "raw", True, True, True, (0.1, 0.3), None, False, 7,
                True, False, None, 2, 3, 1)


def _pair(tmp_path, **kw):
    kw = dict(dict(img_size=64, source="normalize"), **kw)
    return (tdatasets.ISPDataset(_toy_set(tmp_path / "port"), **kw),
            jdatasets.ISPDataset(_toy_set(tmp_path / "jax"), **kw))


def test_letterbox_positional():
    rng = np.random.RandomState(2)
    for hw, shape in (((37, 53), 64), ((80, 30), (48, 96)),
                      ((20, 24), 64)):
        im = rng.rand(*hw, 3).astype(np.float32)
        for args in LETTERBOX_ARGS:
            got, r_t, p_t = letterbox(im, shape, *args)
            want, r_j, p_j = jletterbox(im, shape, *args)
            assert got.shape == want.shape and (r_t, p_t) == (r_j, p_j)
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_isp_dataset_positional(tmp_path):
    root_t, root_j = tmp_path / "port", tmp_path / "jax"
    ds_t = tdatasets.ISPDataset(_toy_set(root_t), *DATASET_ARGS)
    ds_j = jdatasets.ISPDataset(_toy_set(root_j), *DATASET_ARGS)
    assert len(ds_t) == len(ds_j) == 7
    assert (ds_t.augment, ds_t.decode_threads, ds_t.high_res) == (
        True, 1, True)
    # cache_labels=False: no label cache written
    assert not list((root_t / "labels").glob("*.cache"))
    a, b = ds_t.get_batch([3, 0, 5]), ds_j.get_batch([3, 0, 5])
    _same_record(a, b)
    for x, y in zip(a["im_hr"], b["im_hr"]):
        np.testing.assert_allclose(x, y, rtol=0, atol=1e-6)


def test_batch_feeder_positional(tmp_path):
    ds_t, ds_j = _pair(tmp_path)
    # (dataset, batch_size, shuffle, prefetch, seed)
    f_t = tdatasets.BatchFeeder(ds_t, 4, False, False, 3)
    f_j = jdatasets.BatchFeeder(ds_j, 4, False, False, 3)
    assert f_t._prefetcher is None
    for _ in range(3):   # 12 records: into the second epoch, in order
        a = f_t.next_batch()
        _same_record(a, f_j.next_batch())
    assert [p.rsplit("/", 1)[-1] for p in a["path"]] == [
        "8.png", "9.png", "0.png", "1.png"]


def test_replay_memory_positional(tmp_path):
    kw = dict(replay_memory_size=6, maximum_trajectory_length=2)
    ds_t, ds_j = _pair(tmp_path)
    # (cfg, dataset, batch_size, load, feeder_batch, seed, prefetch)
    rm_t = ReplayMemory(Config(**kw), ds_t, 2, False, 4, 5, False)
    rm_j = JReplayMemory(JConfig(**kw), ds_j, 2, False, 4, 5, False)
    assert rm_t.pool == [] and rm_t.feeder._prefetcher is None
    for _ in range(2):
        _feeds_equal(rm_t.get_feed_dict_and_states(2),
                     rm_j.get_feed_dict_and_states(2))
    assert len(rm_t.pool) == len(rm_j.pool)


def test_device_replay_positional(tmp_path):
    from adaptiveisp_tpu.data.replay_device import (
        DeviceReplayMemory as JDeviceReplayMemory,
    )
    from adaptiveisp_tpu_torch.data.replay_device import DeviceReplayMemory

    kw = dict(replay_memory_size=6, maximum_trajectory_length=2)
    ds_t, ds_j = _pair(tmp_path)

    def loss_t(images, labels):
        return images.mean(dim=(1, 2, 3))[:, None]

    def loss_j(images, labels):
        return jnp.mean(images, axis=(1, 2, 3))[:, None]

    # (cfg, dataset, batch_size, feeder_batch, seed, prefetch, mesh,
    # loss_fn); the port's device after JAX's arguments
    pt = DeviceReplayMemory(Config(**kw), ds_t, 2, 4, 3, False, None, loss_t,
                            "cpu")
    pj = JDeviceReplayMemory(JConfig(**kw), ds_j, 2, 4, 3, False, None,
                             loss_j)
    assert pt.feeder._prefetcher is None and pt.device.type == "cpu"
    np.testing.assert_allclose(pt.images.numpy(), np.asarray(pj.images),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(pt.loss_in.numpy(), np.asarray(pj.loss_in),
                               rtol=0, atol=1e-6)
    st, sj = pt.sample(2), pj.sample(2)
    np.testing.assert_array_equal(st[0], sj[0])
    np.testing.assert_allclose(st[1].numpy(), np.asarray(sj[1]), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("args", [
    # (conf, iou, max_det, max_nms, multi_label, agnostic, block, nm,
    # merge, classes)
    (0.001, 0.6, 300, 4096, True, False, 64, 0, False, None),
    (0.1, 0.5, 50, 1024, False, True, 128, 0, True, (0, 3, 5)),
])
def test_nms_positional(args):
    pred = _decoded(17)
    det_j, n_j = jnms(jnp.asarray(pred), *args)
    det_t, n_t = non_max_suppression(torch.from_numpy(pred), *args)
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
    assert int(n_t.min()) > 0
    det_j = np.asarray(det_j)
    np.testing.assert_allclose(det_t[..., :4].numpy(), det_j[..., :4],
                               atol=1e-4)
    np.testing.assert_allclose(det_t[..., 4].numpy(), det_j[..., 4],
                               atol=1e-6)
    np.testing.assert_array_equal(det_t[..., 5].numpy(), det_j[..., 5])
    # the block size does not change the result
    again, n2 = non_max_suppression(torch.from_numpy(pred),
                                    *args[:6], 512, *args[7:])
    assert torch.equal(again, det_t) and torch.equal(n2, n_t)
