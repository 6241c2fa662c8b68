"""The port's scripted render and symmetric NLM forward against the JAX
package.

``ops.bank.render_pipeline`` on the CPU (the stage-by-stage chain, the plain
version of the K4 kernel) is held against JAX's fused Pallas kernel in
interpret mode and against JAX's own ``bank.render_pipeline``: the four cases
of ``tests/test_pallas_pipeline.py``, four interleaved sharpen stages, and a
chain split by ``denoise``.  ``fused_run``'s autograd wiring runs with the
plain chain standing in for K4, against ``jax.grad`` of JAX's stage chain.
K4's call is checked without a card: its cached stage tables and the
(pointer, stride) of each stage's parameters.  The plain NLM
(``nlm_gray_uw``) is held against JAX's symmetric Pallas forward (K3's TPU
kernel) in interpret mode; the port serves ``sym=True`` with K1.  The
``cuda`` cases hold K4 against its plain version and ``sym=True`` against
``sym=False`` on the card and run without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_pipeline.py

Tolerances: rtol 2e-4, atol 2e-5 for the render, those of
``tests/test_pallas_pipeline.py`` for JAX's kernel against its chain (the
fused pass drops ``render_fixed``'s lerp by a mask of ones and rounds
gamma's power another way); 2e-5 for the NLM; ``sym=True`` equals
``sym=False`` bit for bit (one kernel).
"""

import functools
import importlib.util
import sys

import numpy as np
import pytest
import torch

from adaptiveisp_tpu_torch.config import Config
from adaptiveisp_tpu_torch.ops import bank as tb
from adaptiveisp_tpu_torch.ops import denoise as td
from adaptiveisp_tpu_torch.ops.cuda import build
from adaptiveisp_tpu_torch.ops.cuda import nlm as cnlm
from adaptiveisp_tpu_torch.ops.cuda import pipeline as cp
from torch_suite import (  # noqa: F401
    cheap_xla, full_xla, jax_reference, one_torch_thread)

RTOL, ATOL = 2e-4, 2e-5
NLM_ATOL = 2e-5
CFG = Config()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the hand-written K1 and K4 kernels)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def jx():
    """(jax.numpy, JAX Config(), adaptiveisp_tpu.ops.bank, ...pallas)."""
    jax = pytest.importorskip("jax")
    from adaptiveisp_tpu.config import Config as JConfig
    from adaptiveisp_tpu.ops import bank
    from adaptiveisp_tpu.ops.pallas import nlm, pipeline

    return jax, JConfig(), bank, pipeline, nlm


def _sym_case():
    """(rgb, h, gate) of the symmetric Pallas reference: image 1 gated
    off."""
    rng = np.random.RandomState(31)
    rgb = rng.uniform(-0.05, 1.05, (2, 8, 16, 3)).astype(np.float32)
    return (rgb, np.array([[0.3], [0.6]], np.float32),
            np.array([[1.0], [0.0]], np.float32))


def _build_reference(path):
    """JAX's symmetric Pallas forward's (U, W) of :func:`_sym_case` in
    interpret mode, saved to ``path`` (run as a script)."""
    import jax.numpy as jnp

    from adaptiveisp_tpu.ops.pallas import nlm as jnlm

    u, w = jnlm._nlm_forward_uw(*[jnp.asarray(a) for a in _sym_case()],
                                interpret=True, sym=True)
    np.savez(path, u=np.asarray(u), w=np.asarray(w))


@pytest.fixture(scope="module", autouse=True)
def sym_ref(tmp_path_factory):
    """Starts :func:`_build_reference` in its own interpreter, with XLA's
    cheapest CPU compile options, when the module starts, so that it
    compiles while the module's other tests run; yields a function that
    waits for it and returns {"u": U, "w": W}.  Without JAX nothing
    starts."""
    if importlib.util.find_spec("jax") is None:
        yield lambda: pytest.skip("needs jax")
        return
    path = tmp_path_factory.mktemp("nlm_sym_ref") / "ref.npz"
    with jax_reference(__file__, path) as wait:
        @functools.cache
        def result():
            wait()
            with np.load(path) as z:
                return dict(z)

        yield result


def _full(n, *vals):
    return np.tile(np.asarray(vals, np.float32)[None], (n, 1))


def _stages_5(n, rng=None):
    """The JAX bench's 5-stage chain (``bench.py:170-178``); with ``rng``
    each image gets its own parameters around the bench's."""
    stages = [("exposure", _full(n, 1.2)),
              ("improved_wb", _full(n, 2.40, 1.22, 1.88)),
              ("ccm", _full(n, *(np.eye(3) * 1.2).reshape(9))),
              ("gamma", _full(n, 0.45)),
              ("sharpen", _full(n, 3.0))]
    if rng is not None:
        stages = [(nm, (p * rng.uniform(0.8, 1.2, p.shape)).astype(
            np.float32)) for nm, p in stages]
    return stages


def _sharpen4(n):
    """Four sharpen / sharpen_v2 stages interleaved with pointwise ones."""
    return [("exposure", _full(n, 0.3)), ("sharpen", _full(n, 1.5)),
            ("wnb", _full(n, 0.3)), ("sharpen_v2", _full(n, 0.6)),
            ("gamma", _full(n, 0.8)), ("sharpen", _full(n, 0.7)),
            ("contrast", _full(n, 0.4)), ("sharpen_v2", _full(n, 0.3)),
            ("improved_wb", _full(n, 1.1, 0.9, 1.0))]


def _case(name):
    """(img, stages) of ``tests/test_pallas_pipeline.py``'s cases and the
    four-sharpen chain (H = 24: three 8-row Pallas tiles)."""
    rng = np.random.RandomState(23)
    if name == "5stage":
        return rng.rand(2, 16, 128, 3).astype(np.float32), _stages_5(2)
    if name == "pointwise_stack":
        return rng.rand(1, 16, 128, 3).astype(np.float32), [
            ("tone", (0.5 + 1.5 * rng.rand(1, 8)).astype(np.float32)),
            ("contrast", _full(1, 0.4)), ("wnb", _full(1, 0.3)),
            ("saturation_plus", _full(1, 0.6))]
    if name == "multi_tile_sharpen":
        return rng.rand(1, 48, 128, 3).astype(np.float32), [
            ("sharpen", _full(1, 5.0))]
    if name == "per_sample_params":
        return rng.rand(2, 16, 128, 3).astype(np.float32), [
            ("exposure", np.array([[0.5], [2.0]], np.float32))]
    return rng.rand(1, 24, 128, 3).astype(np.float32), _sharpen4(1)


def _torch_stages(stages, device="cpu"):
    return [(nm, torch.from_numpy(p).to(device)) for nm, p in stages]


@pytest.mark.parametrize("name", ["5stage", "pointwise_stack",
                                  "multi_tile_sharpen", "per_sample_params",
                                  "four_sharpen"])
def test_render_pipeline_matches_jax_fused_and_chain(jx, name, monkeypatch):
    jax, jcfg, jbank, jpipe, _ = jx
    jnp = jax.numpy
    img, stages = _case(name)
    jstages = [(nm, jnp.asarray(p)) for nm, p in stages]
    want_fused = np.asarray(jpipe.render_pipeline_fused(
        jcfg, jnp.asarray(img), jstages, interpret=True))
    want_chain = np.asarray(jbank.render_pipeline(jcfg, jnp.asarray(img),
                                                  jstages))

    def no_kernel(*a, **k):
        raise AssertionError("the CPU path reached a kernel wrapper")

    monkeypatch.setattr(cp, "fused_run", no_kernel)
    monkeypatch.setattr(cp, "render_pipeline_fused", no_kernel)
    before = dict(build.LAUNCHES)
    got = tb.render_pipeline(CFG, torch.from_numpy(img),
                             _torch_stages(stages)).numpy()
    assert build.LAUNCHES == before
    np.testing.assert_allclose(got, want_fused, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, want_chain, rtol=RTOL, atol=ATOL)


def test_chain_split_by_denoise_matches_jax(jx):
    jax, jcfg, jbank, _, _ = jx
    jnp = jax.numpy
    rng = np.random.RandomState(4)
    img = rng.rand(1, 16, 16, 3).astype(np.float32)
    stages = [("exposure", _full(1, 0.3)),
              ("improved_wb", _full(1, 1.1, 0.95, 1.05)),
              ("denoise", _full(1, 0.3)), ("gamma", _full(1, 0.8)),
              ("sharpen", _full(1, 1.5)), ("saturation_plus", _full(1, 0.6))]
    want = jax.jit(lambda x: jbank.render_pipeline(
        jcfg, x, [(nm, jnp.asarray(p)) for nm, p in stages]))(
            jnp.asarray(img))
    got = tb.render_pipeline(CFG, torch.from_numpy(img),
                             _torch_stages(stages))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_fusable_runs_split_at_other_stages_and_kernel_limits():
    p = np.zeros((1, 1), np.float32)

    def plan(names):
        return [(f, [s[0] for s in g])
                for f, g in tb.fusable_runs([(nm, p) for nm in names])]

    assert plan(["exposure", "improved_wb", "denoise", "gamma", "sharpen",
                 "tone_v2", "sharpen_usm", "ccm"]) == [
        (True, ["exposure", "improved_wb"]), (False, ["denoise"]),
        (True, ["gamma", "sharpen"]), (False, ["tone_v2"]),
        (False, ["sharpen_usm"]), (True, ["ccm"])]
    five = ["sharpen", "sharpen_v2", "sharpen", "gamma", "sharpen",
            "sharpen_v2"]
    assert plan(five) == [(True, five[:5]), (True, five[5:])]
    long = ["exposure"] * (cp.MAX_STAGES + 1)
    assert [len(g) for _, g in plan(long)] == [cp.MAX_STAGES, 1]


def test_fused_run_wiring_matches_jax_grad(jx, full_xla, monkeypatch):
    """``fused_run`` with the plain chain standing in for K4: the gradients
    with respect to the image and every stage's per-image parameters
    against ``jax.grad`` of JAX's stage chain (``render_fixed`` in turn),
    for a seeded cotangent.  At XLA's default level (``full_xla``): the
    chain's gradient at level 0 misses this test's tolerance."""
    jax, jcfg, jbank, _, _ = jx
    jnp = jax.numpy
    rng = np.random.RandomState(7)
    n = 2
    img = rng.uniform(0.02, 0.98, (n, 12, 20, 3)).astype(np.float32)
    stages = [("exposure", rng.uniform(-0.3, 0.3, (n, 1))),
              ("improved_wb", rng.uniform(0.8, 1.2, (n, 3))),
              ("ccm", np.eye(3).reshape(1, 9) + rng.uniform(
                  0.0, 0.1, (n, 9))),
              ("sharpen", rng.uniform(0.5, 2.0, (n, 1))),
              ("tone", rng.uniform(0.5, 2.0, (n, 8))),
              ("color", rng.uniform(0.9, 1.1, (n, 8, 3))),
              ("gamma", rng.uniform(0.7, 1.3, (n, 1))),
              ("sharpen_v2", rng.uniform(0.2, 0.8, (n, 1))),
              ("contrast", rng.uniform(0.1, 0.5, (n, 1))),
              ("wnb", rng.uniform(0.1, 0.4, (n, 1))),
              ("saturation_plus", rng.uniform(0.2, 0.8, (n, 1)))]
    stages = [(nm, p.astype(np.float32)) for nm, p in stages]
    g = rng.randn(*img.shape).astype(np.float32)
    names = [nm for nm, _ in stages]

    def loss(x, ps):
        for nm, p in zip(names, ps):
            x = jbank.render_fixed(jcfg, x, nm, p)
        return jnp.sum(x * g)

    want = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        jnp.asarray(img), [jnp.asarray(p) for _, p in stages])

    calls = []

    def plain(cfg, x, st):
        calls.append([nm for nm, _ in st])
        return tb.render_pipeline(cfg, x, st, allow_fused=False)

    monkeypatch.setattr(cp, "render_pipeline_fused", plain)
    x = torch.from_numpy(img).requires_grad_(True)
    ps = [torch.from_numpy(p).requires_grad_(True) for _, p in stages]
    out = cp.fused_run(CFG, x, list(zip(names, ps)))
    assert out.grad_fn is not None and calls == [names]
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want[0]),
                               rtol=1e-4, atol=1e-5)
    for (nm, _), p, w in zip(stages, ps, want[1]):
        w = np.asarray(w)
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max(),
                                   err_msg=nm)


def test_fused_run_without_gradient_calls_k4_directly(monkeypatch):
    """With no gradient to take, ``fused_run`` launches K4 without the
    autograd function (the plain chain standing in for K4)."""
    calls = []

    def plain(cfg, x, st):
        calls.append([nm for nm, _ in st])
        return tb.render_pipeline(cfg, x, st, allow_fused=False)

    monkeypatch.setattr(cp, "render_pipeline_fused", plain)
    img, stages = _case("5stage")
    x = torch.from_numpy(img).requires_grad_(True)
    with torch.no_grad():
        out = cp.fused_run(CFG, x, _torch_stages(stages))
    out2 = cp.fused_run(CFG, x.detach(), _torch_stages(stages))
    assert out.grad_fn is None and out2.grad_fn is None
    assert calls == [[nm for nm, _ in stages]] * 2
    torch.testing.assert_close(out, out2, rtol=0, atol=0)


def test_pipeline_wrapper_raises_on_cpu_tensor_and_bad_chains():
    img = torch.rand(1, 8, 8, 3)
    with pytest.raises(ValueError, match="CUDA"):
        cp.render_pipeline_fused(CFG, img, [("exposure", _full(1, 0.2))])
    with pytest.raises(ValueError, match="not fusable"):
        cp.render_pipeline_fused(CFG, img, [("denoise", _full(1, 0.2))])
    with pytest.raises(ValueError, match="sharpen"):
        cp.render_pipeline_fused(CFG, img, [("sharpen", _full(1, 1.0))] * 5)


def test_pack_params_broadcasts_and_follows_curve_steps():
    img = torch.zeros(2, 4, 4, 3)
    stages = [("exposure", torch.tensor([[0.3]])),
              ("color", torch.arange(48.0).reshape(2, 8, 3)),
              ("tone", torch.ones(1, 8))]
    p = cp.pack_params(CFG, img, stages)
    assert p.shape == (2, 1 + 24 + 8) and p.is_contiguous()
    torch.testing.assert_close(p[:, 0], torch.full((2,), 0.3))
    assert p[1, 1:25].tolist() == list(range(24, 48))
    assert cp._plan(CFG.replace(curve_steps=4), ["tone", "color"]) == (
        [(0, 4), (4, 16)], 16)


def test_chain_table_is_cached_per_names_and_curve_steps():
    """The plan and the ctypes stage table are built once per (stage names,
    ``cfg.curve_steps``) and rebuilt for another ``curve_steps``."""
    names = ["exposure", "tone", "color", "sharpen"]
    ch = cp.chain(CFG, names)
    assert cp.chain(CFG, list(names)) is ch
    assert ch.counts == (1, 8, 24, 1) and ch.n_params == 34
    assert list(ch.ops) == [cp.OPS.index(nm) for nm in names]
    assert list(ch.offs) == [0, 1, 9, 33] and list(ch.cnts) == [1, 8, 24, 1]
    ch4 = cp.chain(CFG.replace(curve_steps=4), names)
    assert ch4 is not ch and ch4.counts == (1, 4, 12, 1)
    assert list(ch4.offs) == [0, 1, 5, 17]
    with pytest.raises(ValueError, match="sharpen"):
        cp.chain(CFG, ["sharpen"] * (cp.HALO_ALLOC + 1))
    with pytest.raises(ValueError, match="stages"):
        cp.chain(CFG, ["exposure"] * (cp.MAX_STAGES + 1))
    with pytest.raises(ValueError, match="parameters per image"):
        cp.chain(CFG.replace(curve_steps=400), ["color"])


def test_param_rows_read_in_place_or_made_contiguous_float32():
    """Each stage's (tensor, per-image stride): a [1, n] row and a broadcast
    [N, n] row are read where they lie with stride 0, an [N, n] tensor with
    stride n; a non-contiguous or float64 parameter is made contiguous
    float32; one on another device raises."""
    n, cpu = 3, torch.device("cpu")
    row = torch.tensor([[0.3]])
    per_image = torch.rand(n, 3)
    color = torch.rand(n, 8, 3)
    bcast = torch.tensor([[1.1, 0.9, 1.0]]).expand(n, 3)
    strided = torch.rand(3, n).t()                 # [n, 3], column stride n
    wide = torch.rand(n, 1, dtype=torch.float64)
    stages = [("exposure", row), ("improved_wb", per_image),
              ("color", color), ("improved_wb", bcast),
              ("improved_wb", strided), ("gamma", wide)]
    rows, strides = cp.param_rows(stages, [1, 3, 24, 3, 3, 1], n, cpu)
    assert strides == [0, 3, 24, 0, 3, 1]
    for k in range(4):   # read in place
        assert rows[k].data_ptr() == stages[k][1].data_ptr()
    assert rows[4].is_contiguous() and rows[4].data_ptr() != strided.data_ptr()
    torch.testing.assert_close(rows[4], strided, rtol=0, atol=0)
    assert rows[5].dtype == torch.float32 and rows[5].is_contiguous()
    torch.testing.assert_close(rows[5], wide.float(), rtol=0, atol=0)
    with pytest.raises(ValueError, match="expected"):
        cp.param_rows([("exposure", torch.rand(2, 1))], [1], n, cpu)
    with pytest.raises(ValueError, match="img on"):
        cp.param_rows([("exposure", torch.rand(1, 1, device="meta"))], [1],
                      n, cpu)


def test_nlmgray_sym_forwards_to_k3_and_backward_to_k2(monkeypatch):
    """The registered operator ``nlm_gray`` with ``sym=True``: its kernel
    route passes ``sym`` on to ``nlm_gray_fwd`` (which serves JAX's K3 with
    K1), the backward is K2 as without it (plain versions standing in for
    the kernels, CPU tensors sent down the kernel route)."""
    seen = []

    def fwd(rgb, h, gate, sym=False):
        seen.append(("fwd", sym))
        u, w = td.nlm_gray_uw(rgb, h)
        on = (gate != 0).reshape(-1, 1, 1, 1)
        return torch.where(on, u, 0.0), torch.where(on, w, 0.0)

    def bwd(*args):
        seen.append(("bwd", None))
        return td.nlm_gray_bwd_plain(*args)

    monkeypatch.setattr(cnlm, "nlm_gray_fwd", fwd)
    monkeypatch.setattr(cnlm, "nlm_gray_bwd", bwd)
    rng = np.random.RandomState(2)
    rgb = rng.uniform(0.0, 1.0, (2, 10, 12, 3)).astype(np.float32)
    g = torch.from_numpy(rng.randn(2, 10, 12, 3).astype(np.float32))
    gate = torch.tensor([[1.0], [0.0]])
    grads = []
    with cnlm.nlm_gray_op.set_kernel_enabled("cpu", False), \
            cnlm.nlm_gray_bwd_op.set_kernel_enabled("cpu", False):
        for sym in (False, True):
            x = torch.from_numpy(rgb).requires_grad_(True)
            h = torch.tensor([[0.3], [0.5]], requires_grad=True)
            out = cnlm.nlm_gray(x, h, gate, sym)
            out.backward(g)
            grads.append((out.detach(), x.grad, h.grad))
    assert seen == [("fwd", False), ("bwd", None), ("fwd", True),
                    ("bwd", None)]
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_sym_wrapper_raises_on_cpu_tensor():
    rgb = torch.rand(1, 8, 8, 3)
    with pytest.raises(ValueError, match="CUDA"):
        cnlm.nlm_gray_fwd(rgb, torch.ones(1, 1), torch.ones(1, 1), sym=True)


def test_sym_interpret_matches_plain_uw(sym_ref):
    """JAX's symmetric Pallas forward (interpret mode) against the port's
    plain (U, W), gated: the same function as K1's."""
    rgb, h, _ = _sym_case()
    ref = sym_ref()
    u_t, w_t = td.nlm_gray_uw(torch.from_numpy(rgb), torch.from_numpy(h))
    np.testing.assert_allclose(u_t[:1].numpy(), ref["u"][:1], atol=NLM_ATOL)
    np.testing.assert_allclose(w_t[:1].numpy(), ref["w"][:1], rtol=1e-5)
    assert not np.any(ref["u"][1]) and not np.any(ref["w"][1])


def _close(got, want):
    bad = (got - want).abs() > ATOL + RTOL * want.abs()
    return int(bad.sum())


def _pointwise_4k(rng):
    """The nine pointwise stages on one 2160 x 3840 frame."""
    img = rng.uniform(-0.1, 1.1, (1, 2160, 3840, 3)).astype(np.float32)
    return img, [(nm, np.asarray(p, np.float32)) for nm, p in (
        ("tone", rng.uniform(0.5, 2.0, (1, 8))),
        ("color", rng.uniform(0.9, 1.1, (1, 8, 3))),
        ("contrast", _full(1, 0.4)), ("wnb", _full(1, 0.3)),
        ("saturation_plus", _full(1, 0.6)),
        ("improved_wb", _full(1, 1.2, 0.9, 1.1)), ("gamma", _full(1, 0.7)),
        ("exposure", _full(1, 0.2)),
        ("ccm", np.eye(3).reshape(1, 9) + rng.uniform(-0.1, 0.1, (1, 9))))]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["5stage_main", "pointwise_special",
                                  "four_sharpen_odd", "tiny",
                                  "pointwise_4k"])
def test_k4_matches_plain_chain_on_card(cuda_device, case):
    rng = np.random.RandomState(41)
    if case == "5stage_main":
        img = rng.rand(8, 512, 512, 3).astype(np.float32)
        stages = _stages_5(8, rng)
    elif case == "four_sharpen_odd":
        img = rng.uniform(-0.1, 1.1, (2, 37, 53, 3)).astype(np.float32)
        stages = _sharpen4(2)
    elif case == "tiny":   # smaller than a 16-byte group's row
        img = rng.uniform(-0.1, 1.1, (1, 6, 9, 3)).astype(np.float32)
        stages = _sharpen4(1)
    elif case == "pointwise_4k":
        img, stages = _pointwise_4k(rng)
    else:
        img = rng.uniform(-0.2, 1.2, (2, 33, 70, 3)).astype(np.float32)
        img[0, :4] = 0.0
        img[0, 4:8] = 1.0
        img[1, :6] = rng.rand(6, 70, 1)          # grey: max == min
        img[1, 6:12, :, 1] = img[1, 6:12, :, 0]  # two-channel ties
        stages = [("tone", rng.uniform(0.5, 2.0, (2, 8))),
                  ("color", rng.uniform(0.9, 1.1, (2, 8, 3))),
                  ("contrast", _full(2, 0.4)), ("wnb", _full(2, 0.3)),
                  ("saturation_plus", _full(2, 0.6)),
                  ("improved_wb", _full(2, 1.2, 0.9, 1.1)),
                  ("gamma", _full(2, 0.7)), ("exposure", _full(2, 0.2)),
                  ("ccm", _full(2, 1.1, 0.1, -0.05, 0.0, 0.9, 0.1,
                                -0.1, 0.2, 1.0))]
        stages = [(nm, p.astype(np.float32)) for nm, p in stages]
    x = torch.from_numpy(img).to(cuda_device)
    st = _torch_stages(stages, cuda_device)
    before = build.LAUNCHES["pipeline_fwd"]
    got = cp.render_pipeline_fused(CFG, x, st)
    torch.cuda.synchronize()
    assert build.LAUNCHES["pipeline_fwd"] == before + 1
    want = tb.render_pipeline(CFG, x, st, allow_fused=False)
    assert _close(got, want) == 0, float((got - want).abs().max())


@pytest.mark.cuda
def test_render_pipeline_launch_counts_on_card(cuda_device):
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.rand(2, 40, 72, 3).astype(np.float32)).to(
        cuda_device)
    stages = _torch_stages([
        ("exposure", _full(2, 0.3)), ("improved_wb", _full(2, 1.1, 0.9, 1.0)),
        ("denoise", _full(2, 0.3)), ("gamma", _full(2, 0.8)),
        ("sharpen", _full(2, 1.5)), ("saturation_plus", _full(2, 0.6))],
        cuda_device)
    build.reset_launches()
    got = tb.render_pipeline(CFG, x, stages)
    torch.cuda.synchronize()
    assert build.LAUNCHES == {"nlm_gray_fwd": 1, "nlm_gray_bwd": 0,
                              "pipeline_fwd": 2}
    want = tb.render_pipeline(CFG, x.cpu(), [(nm, p.cpu())
                                             for nm, p in stages])
    assert _close(got.cpu(), want) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 512, 512), (2, 37, 53)])
def test_k3_matches_plain_and_k1_on_card(cuda_device, shape):
    n = shape[0]
    rng = np.random.RandomState(8)
    rgb = torch.from_numpy(rng.uniform(-0.05, 1.05, (*shape, 3)).astype(
        np.float32)).to(cuda_device)
    h_np = rng.uniform(0.02, 1.0, (n, 1)).astype(np.float32)
    h_np[0] = 0.0
    h = torch.from_numpy(h_np).to(cuda_device)
    gate = torch.tensor([1.0, 0.0, 0.3, 1.0, 0.0, 1.0, 1.0, 0.0][:n],
                        device=cuda_device)[:, None].contiguous()
    u3, w3 = cnlm.nlm_gray_fwd(rgb, h, gate, sym=True)
    u1, w1 = cnlm.nlm_gray_fwd(rgb, h, gate)
    torch.cuda.synchronize()
    u_p, w_p = td.nlm_gray_uw(rgb, h)
    on = (gate != 0).reshape(n, 1, 1, 1)
    torch.testing.assert_close(u3, torch.where(on, u_p, 0.0), rtol=0,
                               atol=NLM_ATOL)
    torch.testing.assert_close(w3, torch.where(on, w_p, 0.0), rtol=1e-5,
                               atol=0)
    torch.testing.assert_close(u3, u1, rtol=0, atol=0)
    torch.testing.assert_close(w3, w1, rtol=0, atol=0)
    off = ~on.reshape(n)
    assert not torch.any(u3[off]) and not torch.any(w3[off])


@pytest.mark.cuda
def test_fused_run_gradient_on_card(cuda_device):
    rng = np.random.RandomState(9)
    img = rng.uniform(0.02, 0.98, (2, 64, 96, 3)).astype(np.float32)
    stages = [(nm, (p * rng.uniform(0.9, 1.1, p.shape)).astype(np.float32))
              for nm, p in _stages_5(2)]
    g = torch.from_numpy(rng.randn(*img.shape).astype(np.float32))
    grads = []
    for fused in (True, False):
        x = torch.from_numpy(img).to(cuda_device).requires_grad_(True)
        ps = [torch.from_numpy(p).to(cuda_device).requires_grad_(True)
              for _, p in stages]
        st = [(nm, p) for (nm, _), p in zip(stages, ps)]
        out = (cp.fused_run(CFG, x, st) if fused
               else tb.render_pipeline(CFG, x, st, allow_fused=False))
        out.backward(g.to(cuda_device))
        grads.append([x.grad] + [p.grad for p in ps])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


if __name__ == "__main__":
    _build_reference(sys.argv[1])
