"""The port's gated gray NLM against the JAX package.

The plain PyTorch version (``adaptiveisp_tpu_torch.ops.denoise``) is held
against JAX ``nlm_gray`` and against the Pallas kernel's (U, W) outputs in
interpret mode; the CUDA kernel is held against the plain version on the card
(marked ``cuda``, skipped without one).  JAX is imported by the tests that
use it, so the ``cuda`` cases also run on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_nlm.py
"""

import numpy as np
import pytest
import torch

from adaptiveisp_tpu_torch.ops import denoise as td
from adaptiveisp_tpu_torch.ops.cuda import build
from adaptiveisp_tpu_torch.ops.cuda.nlm import nlm_gray_fwd

# float32 sums in another order and another exp/sqrt: 2e-5 on [0, 1] pixels
ATOL = 2e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the hand-written NLM kernel)")
    return torch.device("cuda")


@pytest.fixture
def jx():
    """(jax, jax.numpy, adaptiveisp_tpu.ops.denoise, ...pallas.nlm)."""
    jax = pytest.importorskip("jax")
    from adaptiveisp_tpu.ops import denoise
    from adaptiveisp_tpu.ops.pallas import nlm

    return jax, jax.numpy, denoise, nlm


def _inputs(seed, n, h, w, hs):
    rng = np.random.RandomState(seed)
    # a little outside [0, 1] so the luminance clip is exercised
    rgb = rng.uniform(-0.05, 1.05, (n, h, w, 3)).astype(np.float32)
    return rgb, np.asarray(hs, np.float32).reshape(n, 1)


@pytest.mark.parametrize("shape,hs", [((2, 64, 64), [0.4, 0.08]),
                                      ((1, 37, 53), [0.25])])
def test_nlm_gray_matches_jax(jx, shape, hs):
    jax, jnp, jd, _ = jx
    rgb, h = _inputs(1, *shape, hs)
    want = np.asarray(jax.jit(jd.nlm_gray)(jnp.asarray(rgb), jnp.asarray(h)))
    got = td.nlm_gray(torch.from_numpy(rgb), torch.from_numpy(h)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_nlm_uw_matches_pallas_interpret_gated(jx):
    """(U, W) of the plain version, masked by the gate, against the Pallas
    kernel's own outputs (interpret mode) with gate [1, 0, 0.3]: gated-off
    images are exactly zero in both."""
    _, jnp, _, jnlm = jx
    rgb, h = _inputs(23, 3, 16, 32, [0.4, 0.2, 0.6])
    gate = np.array([[1.0], [0.0], [0.3]], np.float32)
    u_j, w_j = jnlm._nlm_forward_uw(jnp.asarray(rgb), jnp.asarray(h),
                                    jnp.asarray(gate), interpret=True)
    u_t, w_t = td.nlm_gray_uw(torch.from_numpy(rgb), torch.from_numpy(h))
    on = torch.from_numpy(gate != 0).reshape(3, 1, 1, 1)
    u_t = torch.where(on, u_t, 0.0).numpy()
    w_t = torch.where(on, w_t, 0.0).numpy()
    np.testing.assert_allclose(u_t, np.asarray(u_j), atol=ATOL)
    # W sums 121 weights in (0, 1]: relative tolerance
    np.testing.assert_allclose(w_t, np.asarray(w_j), rtol=1e-5)
    assert not np.any(np.asarray(u_j)[1]) and not np.any(u_t[1])
    assert not np.any(np.asarray(w_j)[1]) and not np.any(w_t[1])


def test_dispatch_routes_cpu_to_plain_version_with_gate(jx):
    jax, jnp, jd, _ = jx
    rgb, h = _inputs(5, 3, 16, 24, [0.3, 0.5, 0.0])
    gate = np.array([0.0, 1.0, 0.7], np.float32)
    rgb_t, h_t = torch.from_numpy(rgb), torch.from_numpy(h)
    before = dict(build.LAUNCHES)
    got = td.nlm_gray_dispatch(rgb_t, h_t, gate=torch.from_numpy(gate))
    assert build.LAUNCHES == before  # the plain version launches nothing
    plain = td.nlm_gray(rgb_t, h_t)
    assert not torch.any(got[0])
    torch.testing.assert_close(got[1:], plain[1:], rtol=0, atol=0)
    # and agrees with the JAX dispatch (XLA path + gate mask on the CPU)
    want = jax.jit(lambda r, hh, g: jd.nlm_gray_dispatch(r, hh, gate=g))(
        jnp.asarray(rgb), jnp.asarray(h), jnp.asarray(gate))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_canon_gate_makes_a_one_hot_column_contiguous():
    onehot = torch.eye(10)[[4, 0, 4]]
    gate = td.canon_gate(onehot[:, 4], 3, "cpu")
    assert gate.is_contiguous() and gate.shape == (3, 1)
    assert gate.flatten().tolist() == [1.0, 0.0, 1.0]


def test_kernel_wrapper_raises_on_cpu_tensor():
    rgb, h = _inputs(0, 2, 8, 8, [0.3, 0.3])
    gate = torch.ones((2, 1))
    with pytest.raises(ValueError, match="CUDA"):
        nlm_gray_fwd(torch.from_numpy(rgb), torch.from_numpy(h), gate)


def _check_kernel(cuda_device, rgb, h, gate):
    n = rgb.shape[0]
    rgb_d = torch.from_numpy(rgb).to(cuda_device)
    h_d = torch.from_numpy(h).to(cuda_device)
    gate_d = torch.from_numpy(gate).to(cuda_device)
    u, w = nlm_gray_fwd(rgb_d, h_d, gate_d)
    torch.cuda.synchronize()
    u_p, w_p = td.nlm_gray_uw(rgb_d, h_d)
    on = (gate_d != 0).reshape(n, 1, 1, 1)
    torch.testing.assert_close(u, torch.where(on, u_p, 0.0), rtol=0,
                               atol=ATOL)
    torch.testing.assert_close(w, torch.where(on, w_p, 0.0), rtol=1e-5,
                               atol=0)
    off = ~on.reshape(n)
    assert not torch.any(u[off]) and not torch.any(w[off])
    # K3, the symmetric forward, computes the same function
    u3, _ = nlm_gray_fwd(rgb_d, h_d, gate_d, sym=True)
    torch.testing.assert_close(u, u3, rtol=0, atol=5e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 512, 512), (2, 37, 53), (1, 6, 9)])
def test_kernel_matches_plain_version_on_card(cuda_device, shape):
    n = shape[0]
    rgb, _ = _inputs(3, *shape, [0.0] * n)
    rng = np.random.RandomState(4)
    h = rng.uniform(0.02, 1.0, (n, 1)).astype(np.float32)
    h[0] = 0.0  # a gated-on image with zero strength
    gate = np.array([1, 0, 0.3, 1, 0, 1, 1, 0][:n], np.float32)[:, None]
    _check_kernel(cuda_device, rgb, h, gate)


@pytest.mark.cuda
def test_kernel_matches_plain_version_flat_patches_on_card(cuda_device):
    """Piecewise-constant 8 x 8 blocks of exact 0, 1 and two greys (many
    patch distances exactly 0), images at h = 0 and h = 1e-4."""
    rng = np.random.RandomState(6)
    blocks = rng.choice(np.array([0.0, 1.0, 0.25, 0.625], np.float32),
                        (4, 9, 13, 3))
    rgb = np.ascontiguousarray(
        np.repeat(np.repeat(blocks, 8, 1), 8, 2)[:, :72, :100])
    h = np.array([[0.0], [1e-4], [0.3], [0.5]], np.float32)
    gate = np.array([[1.0], [1.0], [0.5], [0.0]], np.float32)
    _check_kernel(cuda_device, rgb, h, gate)
