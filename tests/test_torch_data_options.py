"""The data layer's options against the JAX package's, by keyword.

``short_names`` / ``param_counts`` of the filter bank; ``letterbox``'s
``auto`` / ``scale_fill`` / ``stride`` and ``restore_image``;
``ISPDataset(augment=, cache_labels=, decode_threads=)``,
``BatchFeeder(shuffle=, prefetch=)``, ``ReplayMemory(load=, prefetch=)``
and ``DeviceReplayMemory(prefetch=)``, each run beside JAX's on the same
seeded files (a copy for each package) as ``test_torch_data.py`` does:
images to 1e-6 (each package resizes with its own build of
``csrc/preprocess.cpp``), labels, paths, states and noise exactly.  And
``url_getsize`` on ``file://`` URLs (no network).
"""

import os

import numpy as np
import pytest

from adaptiveisp_tpu.config import Config as JConfig
from adaptiveisp_tpu.data import artifacts as jartifacts
from adaptiveisp_tpu.data import datasets as jdatasets
from adaptiveisp_tpu.data import letterbox as jletterbox
from adaptiveisp_tpu.data.replay import ReplayMemory as JReplayMemory
from adaptiveisp_tpu.ops import bank as jbank
from adaptiveisp_tpu_torch.config import Config
from adaptiveisp_tpu_torch.configs import config_fast_filters
from adaptiveisp_tpu_torch.data import artifacts
from adaptiveisp_tpu_torch.data import datasets as tdatasets
from adaptiveisp_tpu_torch.data import letterbox as tletterbox
from adaptiveisp_tpu_torch.data.replay import ReplayMemory
from adaptiveisp_tpu_torch.ops import bank
from test_torch_data import _feeds_equal, _same_record, _toy_set
from torch_suite import cheap_xla, one_torch_thread  # noqa: F401


def test_short_names_and_param_counts_match_jax():
    rosters = [Config(), Config(curve_steps=4), config_fast_filters.Config(),
               Config(filters=("tone_v2", "sharpen_usm", "color", "wnb"))]
    for cfg in rosters:
        jcfg = JConfig(filters=cfg.filters, curve_steps=cfg.curve_steps)
        assert bank.short_names(cfg) == jbank.short_names(jcfg)
        assert bank.param_counts(cfg) == jbank.param_counts(jcfg)
        assert bank.param_offsets(cfg) == jbank.param_offsets(jcfg)
        assert isinstance(bank.short_names(cfg), tuple)
    assert bank.short_names(Config())[:4] == ("E", "G", "CCM", "Shr")
    assert sum(bank.param_counts(Config(curve_steps=4))) < sum(
        bank.param_counts(Config()))


def test_letterbox_options_and_restore_image():
    rng = np.random.RandomState(8)
    for hw in ((37, 53), (90, 41), (64, 64)):
        im = rng.rand(*hw, 3).astype(np.float32)
        for kw in (dict(auto=True), dict(auto=True, stride=16),
                   dict(scale_fill=True), dict(scale_fill=True,
                                               scaleup=False),
                   dict(scaleup=False, color=(0.3, 0.3, 0.3))):
            got = tletterbox.letterbox(im, (64, 96), **kw)
            want = jletterbox.letterbox(im, (64, 96), **kw)
            assert got[1:] == want[1:], kw
            np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)
        boxed = tletterbox.letterbox(im, 80)[0]
        back = tletterbox.restore_image(boxed, *hw)
        assert back.shape == im.shape
        np.testing.assert_allclose(
            back, jletterbox.restore_image(boxed, *hw), rtol=0, atol=1e-6)
    # scale_fill stretches: no border, a ratio per axis
    out, ratio, pad = tletterbox.letterbox(im[:40], (64, 96), scale_fill=True)
    assert out.shape == (64, 96, 3) and pad == (0.0, 0.0)
    assert ratio == (96 / 64, 64 / 40)
    # auto pads only to the next multiple of the stride
    out, _, pad = tletterbox.letterbox(rng.rand(25, 90, 3).astype(
        np.float32), 96, auto=True, stride=32)
    assert out.shape == (32, 96, 3) and pad == (0.0, 2.5)


@pytest.mark.parametrize("decode_threads", [1, 4])
def test_dataset_options_match_jax(tmp_path, decode_threads):
    """augment, cache_labels and decode_threads against JAX's; 1 thread
    decodes serially, with the same records as the pool's; no label cache
    is written with cache_labels=False."""
    kw = dict(img_size=64, source="raw", train=True, augment=True,
              add_noise=True, brightness_range=(0.1, 0.3),
              cache_labels=False, decode_threads=decode_threads, seed=2)
    ds_t = tdatasets.ISPDataset(_toy_set(tmp_path / "port"), **kw)
    ds_j = jdatasets.ISPDataset(_toy_set(tmp_path / "jax"), **kw)
    assert not [f for f in os.listdir(tmp_path / "port" / "labels")
                if f.endswith(".cache")]
    for idx in ([5, 2, 2, 7], [0, 9, 1]):
        _same_record(ds_t.get_batch(idx), ds_j.get_batch(idx))
    cached = tdatasets.ISPDataset(_toy_set(tmp_path / "cached"), img_size=64,
                                  source="normalize")
    assert [f for f in os.listdir(tmp_path / "cached" / "labels")
            if f.endswith(".cache")]
    assert len(cached) == len(ds_t)


def test_feeder_options_match_jax(tmp_path):
    """shuffle=False walks every epoch in order; prefetch=False starts no
    thread and gives what the prefetching feeder gives."""
    kw = dict(img_size=64, source="normalize")
    ds_t = tdatasets.ISPDataset(_toy_set(tmp_path / "port"), **kw)
    ds_j = jdatasets.ISPDataset(_toy_set(tmp_path / "jax"), **kw)
    for shuffle in (False, True):
        f_t = tdatasets.BatchFeeder(ds_t, batch_size=4, shuffle=shuffle,
                                    prefetch=False, seed=3)
        f_j = jdatasets.BatchFeeder(ds_j, batch_size=4, shuffle=shuffle,
                                    prefetch=False, seed=3)
        ahead = tdatasets.BatchFeeder(ds_t, batch_size=4, shuffle=shuffle,
                                      seed=3)
        assert f_t._prefetcher is None and ahead._prefetcher is not None
        try:
            paths = []
            for _ in range(5):   # 20 records: two epochs
                a = f_t.next_batch()
                _same_record(a, f_j.next_batch())
                _same_record(a, ahead.next_batch())
                paths += [os.path.basename(p) for p in a["path"]]
        finally:
            ahead.stop()
        f_t.stop()   # no thread: a no-op
        in_order = paths == [f"{i % 10}.png" for i in range(20)]
        assert in_order == (not shuffle)


def test_pool_options_match_jax(tmp_path):
    """ReplayMemory(load=False) fills on its first sample, as JAX's;
    prefetch=False reaches the feeder.  DeviceReplayMemory(prefetch=False)
    holds JAX's images, cached losses and first sample."""
    import jax.numpy as jnp

    from adaptiveisp_tpu.data.replay_device import (
        DeviceReplayMemory as JDeviceReplayMemory,
    )
    from adaptiveisp_tpu_torch.data.replay_device import DeviceReplayMemory

    kw = dict(replay_memory_size=6, maximum_trajectory_length=2)
    cfg, jcfg = Config(**kw), JConfig(**kw)
    dkw = dict(img_size=64, source="normalize")
    ds_t = tdatasets.ISPDataset(_toy_set(tmp_path / "port"), **dkw)
    ds_j = jdatasets.ISPDataset(_toy_set(tmp_path / "jax"), **dkw)
    rm_t = ReplayMemory(cfg, ds_t, 2, load=False, feeder_batch=4, seed=5,
                        prefetch=False)
    rm_j = JReplayMemory(jcfg, ds_j, 2, load=False, feeder_batch=4, seed=5,
                         prefetch=False)
    assert rm_t.pool == [] and rm_t.feeder._prefetcher is None
    rm_t.fill_pool()
    rm_j.fill_pool()
    assert len(rm_t.pool) == 6
    for _ in range(2):
        _feeds_equal(rm_t.get_feed_dict_and_states(2),
                     rm_j.get_feed_dict_and_states(2))
    rm_t.stop()

    pt = DeviceReplayMemory(cfg, ds_t, 2, feeder_batch=4, seed=3,
                            prefetch=False, device="cpu",
                            loss_fn=lambda im, lb: im.mean((1, 2, 3))[:, None])
    pj = JDeviceReplayMemory(jcfg, ds_j, 2, feeder_batch=4, seed=3,
                             prefetch=False,
                             loss_fn=lambda im, lb: jnp.mean(
                                 im, axis=(1, 2, 3))[:, None])
    assert pt.feeder._prefetcher is None
    np.testing.assert_allclose(pt.images.numpy(), np.asarray(pj.images),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(pt.loss_in.numpy(), np.asarray(pj.loss_in),
                               rtol=0, atol=1e-6)
    st, sj = pt.sample(2), pj.sample(2)
    np.testing.assert_array_equal(st[0], sj[0])
    np.testing.assert_allclose(st[1].numpy(), np.asarray(sj[1]), rtol=0,
                               atol=1e-6)
    pt.stop()


def test_url_getsize_on_local_urls(tmp_path):
    f = tmp_path / "weights.bin"
    f.write_bytes(b"\0" * 1234)
    url = f.resolve().as_uri()
    assert artifacts.url_getsize(url) == 1234 == jartifacts.url_getsize(url)
    missing = (tmp_path / "nothing.bin").resolve().as_uri()
    assert artifacts.url_getsize(missing) == -1 == jartifacts.url_getsize(
        missing)
