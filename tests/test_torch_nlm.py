"""The port's gated gray NLM against the JAX package.

The plain PyTorch version (``adaptiveisp_tpu_torch.ops.denoise``) is held
against JAX ``nlm_gray`` and against the Pallas kernel's (U, W) outputs in
interpret mode; the CUDA kernel is held against the plain version on the card
(marked ``cuda``, skipped without one).  JAX is imported by the tests that
use it, so the ``cuda`` cases also run on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_nlm.py

The Pallas reference is built by this file run as a script, in its own
interpreter with XLA's cheapest CPU compile options, started when the
module starts so that it compiles while the module's other tests run.
"""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from adaptiveisp_tpu_torch.ops import denoise as td
from adaptiveisp_tpu_torch.ops.cuda import build
from adaptiveisp_tpu_torch.ops.cuda.nlm import nlm_gray_fwd

# float32 sums in another order and another exp/sqrt: 2e-5 on [0, 1] pixels
ATOL = 2e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHEAP_XLA = ("--xla_backend_optimization_level=0 "
             "--xla_llvm_disable_expensive_passes=true")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one thread while a port test module runs.  A tier-1 run
    has six workers on the host's cores, and torch's default of one
    OpenMP thread per core in each worker oversubscribes them: the port's
    test files took 1,780 s summed that way and 870 s on one thread each
    (6 workers on 8 cores).  The other port test modules import this
    fixture, which makes it theirs too."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def cheap_xla():
    """XLA's cheapest CPU compile options while a port test module runs
    (``jax_disable_most_optimizations``: backend optimisation level 0, no
    expensive LLVM passes), as :data:`CHEAP_XLA` gives the subprocess
    references: the JAX references are compile-bound, and the options
    change their values by float32 rounding only.  The flag is restored
    and the compiled executables dropped afterwards, so none reaches
    another module.  Without JAX (the ``cuda`` runs) it does nothing."""
    if importlib.util.find_spec("jax") is None:
        yield
        return
    import jax

    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)
    jax.clear_caches()


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


def _pallas_case():
    """(rgb, h, gate) of the Pallas reference: gate [1, 0, 0.3]."""
    rgb, h = _inputs(23, 3, 16, 32, [0.4, 0.2, 0.6])
    return rgb, h, np.array([[1.0], [0.0], [0.3]], np.float32)


def _build_reference(path):
    """The Pallas kernel's (U, W) of :func:`_pallas_case` in interpret mode,
    saved to ``path`` (run as a script)."""
    import jax.numpy as jnp

    from adaptiveisp_tpu.ops.pallas import nlm as jnlm

    u, w = jnlm._nlm_forward_uw(*[jnp.asarray(a) for a in _pallas_case()],
                                interpret=True)
    np.savez(path, u=np.asarray(u), w=np.asarray(w))


@pytest.fixture(scope="module", autouse=True)
def pallas_ref(tmp_path_factory):
    """Starts :func:`_build_reference` in its own interpreter when the
    module starts; yields a function that waits for it and returns
    {"u": U, "w": W}.  Without JAX nothing starts."""
    proc, path, done = None, None, {}
    if importlib.util.find_spec("jax") is not None:
        path = tmp_path_factory.mktemp("nlm_fwd_ref") / "ref.npz"
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(path)], cwd=REPO,
            env=dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=CHEAP_XLA,
                     PYTHONPATH=REPO),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def result():
        if proc is None:
            pytest.skip("needs jax")
        if not done:
            log = proc.communicate(timeout=900)[0]
            assert proc.returncode == 0, log
            with np.load(path) as z:
                done.update(z)
        return done

    yield result
    if proc is not None and proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.mark.parametrize("shape,hs", [((2, 64, 64), [0.4, 0.08]),
                                      ((1, 37, 53), [0.25])])
def test_nlm_gray_matches_jax(jx, shape, hs):
    jax, jnp, jd, _ = jx
    rgb, h = _inputs(1, *shape, hs)
    want = np.asarray(jax.jit(jd.nlm_gray)(jnp.asarray(rgb), jnp.asarray(h)))
    got = td.nlm_gray(torch.from_numpy(rgb), torch.from_numpy(h)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


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


def test_nlm_uw_matches_pallas_interpret_gated(pallas_ref):
    """(U, W) of the plain version, masked by the gate, against the Pallas
    kernel's own outputs (interpret mode) with gate [1, 0, 0.3]: gated-off
    images are exactly zero in both."""
    rgb, h, gate = _pallas_case()
    ref = pallas_ref()
    u_t, w_t = td.nlm_gray_uw(torch.from_numpy(rgb), torch.from_numpy(h))
    on = torch.from_numpy(gate != 0).reshape(3, 1, 1, 1)
    u_t = torch.where(on, u_t, 0.0).numpy()
    w_t = torch.where(on, w_t, 0.0).numpy()
    np.testing.assert_allclose(u_t, ref["u"], atol=ATOL)
    # W sums 121 weights in (0, 1]: relative tolerance
    np.testing.assert_allclose(w_t, ref["w"], rtol=1e-5)
    assert not np.any(ref["u"][1]) and not np.any(u_t[1])
    assert not np.any(ref["w"][1]) and not np.any(w_t[1])


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
    # sym=True (JAX's K3, the same function) launches the same kernel
    u3, w3 = nlm_gray_fwd(rgb_d, h_d, gate_d, sym=True)
    torch.testing.assert_close(u3, u, rtol=0, atol=0)
    torch.testing.assert_close(w3, w, rtol=0, atol=0)


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


if __name__ == "__main__":
    _build_reference(sys.argv[1])
