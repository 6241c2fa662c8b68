"""The port's NLM backward against the JAX package.

``nlm_gray_bwd_plain`` (the plain twin of the K2 kernel) is held against the
Pallas backward ``_nlm_backward`` in interpret mode; the CPU autograd of
``nlm_gray_dispatch``, and the wiring of the registered operator
``nlm_gray`` (clip and relu tie gradients, no gate gradient) with the plain
versions standing in for the kernels, against ``jax.vjp`` of JAX's dispatch (the XLA chain) at an odd
shape.  The ``cuda`` cases hold K2 against the plain twin on the
card and run without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_nlm_bwd.py

Both JAX references are built once per module, each by this file run as a
script in a fresh interpreter, the two started together, with XLA's
cheapest CPU compile options (``CHEAP_XLA``).  Each is hundreds of small XLA
compiles (one per roll shift of the eager chain) or one large interpret-mode
kernel; the options about halve their compile time and change the values by
float32 rounding only (6e-7 on dL/drgb, 4e-7 relative on dL/dhh).  The
Pallas backward takes its residuals (U, W) from the plain forward, which
``tests/test_torch_nlm.py`` holds against the Pallas forward's own, so the
interpreter compiles one kernel, not two.

Tolerances: dL/drgb atol 2e-5 and dL/dhh rtol 2e-4, atol 1e-5, those of
``tests/test_pallas_nlm.py`` for the Pallas backward against autodiff
(float32 sums over 121 offsets in another order).
"""

import contextlib
import sys

import numpy as np
import pytest
import torch

from adaptiveisp_tpu_torch.ops import denoise as td
from adaptiveisp_tpu_torch.ops.cuda import build
from adaptiveisp_tpu_torch.ops.cuda import nlm as cnlm
from adaptiveisp_tpu_torch.ops.denoise import canon_gate
from adaptiveisp_tpu_torch.ops.math import clip_grad_mask, rgb_to_luminance
from torch_suite import (  # noqa: F401
    cheap_xla, jax_reference, one_torch_thread)

DRGB_ATOL = 2e-5
DH_RTOL, DH_ATOL = 2e-4, 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the hand-written NLM kernels)")
    return torch.device("cuda")


def _inputs(seed, n, h, w, hs):
    """rgb a little outside [0, 1] with exact 0 and 1 pixels (the clip
    ties), h [N, 1], and a seeded normal cotangent."""
    rng = np.random.RandomState(seed)
    rgb = rng.uniform(-0.05, 1.05, (n, h, w, 3)).astype(np.float32)
    flat = rgb.reshape(-1)
    ties = rng.choice(flat.size, flat.size // 10, replace=False)
    flat[ties[::2]] = 0.0
    flat[ties[1::2]] = 1.0
    g = rng.randn(n, h, w, 3).astype(np.float32)
    return rgb, np.asarray(hs, np.float32).reshape(n, 1), g


def _pallas_case():
    """H = 64 is two of the Pallas backward's 32-row tiles, so its
    cross-tile gather runs; gate [1, 0, 0.3], the 0.3 image with h = 0;
    the blend's cotangent of the gated-off image is zero."""
    rgb, h, g = _inputs(3, 3, 64, 64, [0.4, 0.2, 0.0])
    g[1] = 0.0
    return rgb, h, np.array([[1.0], [0.0], [0.3]], np.float32), g


def _xla_case():
    """An odd shape: gate [0, 1, 0.7], the 0.7 image with h = 0."""
    rgb, h, g = _inputs(5, 3, 37, 53, [0.3, 0.6, 0.0])
    return rgb, h, np.array([0.0, 1.0, 0.7], np.float32), g


def _build_reference(kind, path):
    """JAX's reference for one case, saved to ``path`` (run as a script):
    ``pallas``: the Pallas backward in interpret mode at the plain
    forward's (U, W) (zero for the gated-off image, as the kernel's), with
    v = the clip's VJP of the cotangent; ``xla``: ``jax.vjp`` of JAX's
    ``nlm_gray_dispatch`` (the XLA chain with the gate mask on the CPU)."""
    import jax
    import jax.numpy as jnp

    if kind == "pallas":
        from adaptiveisp_tpu.ops.pallas import nlm as jnlm

        rgb, h, gate, g = _pallas_case()
        args = [jnp.asarray(a) for a in (rgb, h, gate)]
        u, wsum = td.nlm_gray_uw(torch.from_numpy(rgb), torch.from_numpy(h))
        on = torch.from_numpy(gate != 0).reshape(-1, 1, 1, 1)
        u, wsum = (jnp.asarray(torch.where(on, t, 0.0).numpy())
                   for t in (u, wsum))
        _, clip_vjp = jax.vjp(lambda x: jnp.clip(x, 0.0, 1.0), u)
        v = clip_vjp(jnp.asarray(g))[0]
        dr, dh = jnlm._nlm_backward(*args, v, u, wsum, interpret=True)
        out = {"v": v, "dr": dr, "dh": dh}
    else:
        from adaptiveisp_tpu.ops import denoise as jd

        rgb, h, gate, g = _xla_case()
        _, vjp = jax.vjp(lambda r, hh: jd.nlm_gray_dispatch(
            r, hh, gate=jnp.asarray(gate)), jnp.asarray(rgb), jnp.asarray(h))
        dr, dh = vjp(jnp.asarray(g))
        out = {"dr": dr, "dh": dh}
    np.savez(path, **{k: np.asarray(v) for k, v in out.items()})


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    """{"pallas": ..., "xla": ...}: both JAX references, each built by
    :func:`_build_reference` in its own interpreter, the two at once.  The
    tier-1 run (``--dist loadfile``) keeps this file's tests on one worker,
    so each reference is built once, and both at once rather than one
    after the other."""
    pytest.importorskip("jax")
    d = tmp_path_factory.mktemp("nlm_refs")
    out = {}
    with contextlib.ExitStack() as stack:
        waits = {k: stack.enter_context(jax_reference(
            __file__, k, d / f"{k}.npz")) for k in ("pallas", "xla")}
        for k, wait in waits.items():
            wait()
            with np.load(d / f"{k}.npz") as z:
                out[k] = dict(z)
    return out


def test_bwd_plain_matches_pallas_backward_gated(refs):
    """The plain twin against the Pallas backward of :func:`_pallas_case`."""
    rgb, h, gate, _ = _pallas_case()
    ref = refs["pallas"]
    dr_t, dh_t = td.nlm_gray_bwd_plain(
        torch.from_numpy(rgb), torch.from_numpy(h), torch.from_numpy(gate),
        torch.from_numpy(ref["v"]))
    np.testing.assert_allclose(dr_t.numpy(), ref["dr"], atol=DRGB_ATOL)
    np.testing.assert_allclose(dh_t.numpy(), ref["dh"], rtol=DH_RTOL,
                               atol=DH_ATOL)
    assert not torch.any(dr_t[1]) and float(dh_t[1, 0]) == 0.0


@contextlib.contextmanager
def _plain_kernels(monkeypatch):
    """Stand the plain versions in for K1 and K2 inside ``ops.cuda.nlm``
    and send CPU tensors down the registered operators' kernel route (their
    CPU kernels disabled), so the route's own wiring runs on the CPU."""
    def fwd(rgb, h, gate, sym=False):
        u, w = td.nlm_gray_uw(rgb, h)
        on = (gate != 0).reshape(-1, 1, 1, 1)
        return torch.where(on, u, 0.0), torch.where(on, w, 0.0)

    monkeypatch.setattr(cnlm, "nlm_gray_fwd", fwd)
    monkeypatch.setattr(cnlm, "nlm_gray_bwd", td.nlm_gray_bwd_plain)
    with cnlm.nlm_gray_op.set_kernel_enabled("cpu", False), \
            cnlm.nlm_gray_bwd_op.set_kernel_enabled("cpu", False):
        yield


@pytest.fixture(scope="module")
def xla_ref(refs):
    """(rgb, h, gate, g, dL/drgb, dL/dh): ``jax.vjp`` of JAX's
    ``nlm_gray_dispatch`` at :func:`_xla_case`."""
    rgb, h, gate, g = _xla_case()
    return rgb, h, gate, g, refs["xla"]["dr"], refs["xla"]["dh"]


def test_nlmgray_wiring_matches_jax_vjp_odd_shape(xla_ref, monkeypatch):
    """The kernel route of the registered operator ``nlm_gray`` (clip(U)
    forward; backward: clip tie mask on U, K2, relu tie mask on h, no gate
    gradient) with the plain versions standing in for K1 and K2, against
    ``jax.vjp`` at an odd shape."""
    rgb, h, gate, g, dr_j, dh_j = xla_ref
    x = torch.from_numpy(rgb).requires_grad_(True)
    ht = torch.from_numpy(h).requires_grad_(True)
    gt = torch.from_numpy(gate[:, None]).requires_grad_(True)
    with _plain_kernels(monkeypatch):
        out = cnlm.nlm_gray(x, ht, gt)
        assert out.grad_fn is not None
        out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(x.grad.numpy(), dr_j, atol=DRGB_ATOL)
    np.testing.assert_allclose(ht.grad.numpy(), dh_j, rtol=DH_RTOL,
                               atol=DH_ATOL)
    assert gt.grad is None
    assert not torch.any(x.grad[0]) and float(ht.grad[0, 0]) == 0.0


def test_dispatch_cpu_autograd_matches_jax_grad_with_gate(xla_ref):
    rgb, h, gate, g, dr_j, dh_j = xla_ref
    x = torch.from_numpy(rgb).requires_grad_(True)
    ht = torch.from_numpy(h).requires_grad_(True)
    before = dict(build.LAUNCHES)
    td.nlm_gray_dispatch(x, ht, gate=torch.from_numpy(gate)).backward(
        torch.from_numpy(g))
    assert build.LAUNCHES == before   # the CPU path launches nothing
    np.testing.assert_allclose(x.grad.numpy(), dr_j, atol=DRGB_ATOL)
    np.testing.assert_allclose(ht.grad.numpy(), dh_j, rtol=DH_RTOL,
                               atol=DH_ATOL)
    assert not torch.any(x.grad[0]) and float(ht.grad[0, 0]) == 0.0


def _half_offsets(r=5):
    """The 60 offsets of the half set, in the kernels' order."""
    return [(0, dx) for dx in range(1, r + 1)] + [
        (dy, dx) for dy in range(1, r + 1) for dx in range(-r, r + 1)]


def _paired_adjoint(rgb, h, gate, v):
    """Closed-form adjoint of the (U, W) chain as K2 computes it: one weight
    chain per pair (d, -d) of the half set, plus the centre.  With
    (S_d x)(p) = x(p - d), a = v / W and q = -(sum_c v_c U_c) / W:
    g = a . S_d rgb + q and g' = S_d a . rgb + S_d q (dL/dw_-d on the
    d-grid); dL/drgb += S_-d(w a) + w S_d a; dL/dhh += sum w s (g + g');
    db + db' = -(g + g') w / (2 hh s) where b > 0, one box sum for both;
    Z = 2 (y - S_d y) box5(db + db'), dL/dy += Z - S_-d Z."""
    n = rgb.shape[0]
    hh = (h.clamp_min(0.0) + td.EPS)[:, None, None, :]
    u, wsum = td.nlm_gray_uw(rgb, h)
    y = rgb_to_luminance(rgb)
    a = v / wsum
    q = -(v * u).sum(-1, keepdim=True) / wsum
    dr, dy, dh = a.clone(), torch.zeros_like(y), torch.zeros_like(hh)
    for d in _half_offsets():
        fwd = lambda x: torch.roll(x, d, dims=(1, 2))              # noqa
        back = lambda x: torch.roll(x, (-d[0], -d[1]), dims=(1, 2))  # noqa
        diff = y - fwd(y)
        b = td.box_sum(diff * diff, 5)
        pos = b > 0
        s = torch.where(pos, torch.sqrt(torch.where(pos, b, 1.0)), 0.0)
        w = torch.exp(-s / hh)
        gg = ((a * fwd(rgb)).sum(-1, keepdim=True) + q
              + (fwd(a) * rgb).sum(-1, keepdim=True) + fwd(q))
        dr = dr + back(w * a) + w * fwd(a)
        dh = dh + (w * s * gg).sum((1, 2, 3), keepdim=True)
        db = torch.where(pos, -0.5 * gg * w
                         / (hh * torch.where(pos, s, 1.0)), 0.0)
        z = 2.0 * diff * td.box_sum(db, 5)
        dy = dy + z - back(z)
    lum = torch.tensor([0.299, 0.587, 0.114])
    dr = dr + lum * clip_grad_mask(rgb, 0.0, 1.0) * dy
    on = canon_gate(gate, n, rgb.device) != 0
    return (torch.where(on.reshape(n, 1, 1, 1), dr, 0.0),
            torch.where(on, (dh / (hh * hh)).reshape(n, 1), 0.0))


def _flat_patches(seed, n, h, w):
    """Piecewise-constant 8 x 8 blocks of exact 0, 1 and two greys: many
    patch distances are exactly 0."""
    rng = np.random.RandomState(seed)
    blocks = rng.choice(np.array([0.0, 1.0, 0.25, 0.625], np.float32),
                        (n, -(-h // 8), -(-w // 8), 3))
    return np.ascontiguousarray(
        np.repeat(np.repeat(blocks, 8, 1), 8, 2)[:, :h, :w])


def test_paired_adjoint_matches_pallas_backward(refs):
    """The pairing identities K2 uses, against the Pallas backward of
    :func:`_pallas_case` (gate [1, 0, 0.3], the 0.3 image at h = 0)."""
    rgb, h, gate, _ = _pallas_case()
    ref = refs["pallas"]
    dr, dh = _paired_adjoint(torch.from_numpy(rgb), torch.from_numpy(h),
                             torch.from_numpy(gate),
                             torch.from_numpy(ref["v"]))
    np.testing.assert_allclose(dr.numpy(), ref["dr"], atol=DRGB_ATOL)
    np.testing.assert_allclose(dh.numpy(), ref["dh"], rtol=DH_RTOL,
                               atol=DH_ATOL)
    assert not torch.any(dr[1]) and float(dh[1, 0]) == 0.0


def test_paired_adjoint_matches_plain_flat_patches():
    """The pairing identities against ``nlm_gray_bwd_plain`` at an odd
    shape of flat 8 x 8 patches (exact zero distances), one image at
    h = 0."""
    rgb = torch.from_numpy(_flat_patches(7, 2, 37, 53))
    h = torch.tensor([[0.3], [0.0]])
    gate = torch.ones((2, 1))
    g = torch.from_numpy(np.random.RandomState(8).randn(2, 37, 53, 3)
                         .astype(np.float32))
    v = g * clip_grad_mask(td.nlm_gray_uw(rgb, h)[0], 0.0, 1.0)
    dr_p, dh_p = td.nlm_gray_bwd_plain(rgb, h, gate, v)
    dr, dh = _paired_adjoint(rgb, h, gate, v)
    torch.testing.assert_close(dr, dr_p, rtol=0, atol=DRGB_ATOL)
    torch.testing.assert_close(dh, dh_p, rtol=DH_RTOL, atol=DH_ATOL)


def test_bwd_wrapper_raises_on_cpu_tensor():
    rgb, h, g = _inputs(0, 2, 8, 8, [0.3, 0.3])
    t = torch.from_numpy
    gate = torch.ones((2, 1))
    with pytest.raises(ValueError, match="CUDA"):
        cnlm.nlm_gray_bwd(t(rgb), t(h), gate, t(g), t(rgb),
                          torch.ones((2, 8, 8, 1)))


def _check_kernel_bwd(device, rgb, h, gate, g):
    n = rgb.shape[0]
    rgb_d, h_d, gate_d = (torch.from_numpy(a).to(device)
                          for a in (rgb, h, gate))
    u, w = cnlm.nlm_gray_fwd(rgb_d, h_d, gate_d)
    on = (gate_d != 0).reshape(n, 1, 1, 1)
    v = torch.where(on, torch.from_numpy(g).to(device), 0.0) \
        * clip_grad_mask(u, 0.0, 1.0)
    dr, dhh = cnlm.nlm_gray_bwd(rgb_d, h_d, gate_d, v.contiguous(), u, w)
    torch.cuda.synchronize()
    dr_p, dhh_p = td.nlm_gray_bwd_plain(rgb_d, h_d, gate_d, v)
    torch.testing.assert_close(dr, dr_p, rtol=0, atol=DRGB_ATOL)
    torch.testing.assert_close(dhh, dhh_p, rtol=DH_RTOL, atol=DH_ATOL)
    off = ~on.reshape(n)
    assert not torch.any(dr[off]) and not torch.any(dhh[off])


@pytest.mark.cuda
def test_kernel_bwd_matches_plain_flat_patches_on_card(cuda_device):
    """Flat 8 x 8 patches (exact zero distances), images at h = 0 and
    h = 1e-4, one gated off."""
    rgb = _flat_patches(14, 4, 72, 100)
    h = np.array([[0.0], [1e-4], [0.3], [0.5]], np.float32)
    gate = np.array([[1.0], [1.0], [0.5], [0.0]], np.float32)
    g = np.random.RandomState(15).randn(*rgb.shape).astype(np.float32)
    _check_kernel_bwd(cuda_device, rgb, h, gate, g)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 512, 512), (2, 37, 53), (1, 6, 9)])
def test_kernel_bwd_matches_plain_on_card(cuda_device, shape):
    n = shape[0]
    rgb, _, g = _inputs(11, *shape, [0.0] * n)
    rng = np.random.RandomState(12)
    h = rng.uniform(0.02, 1.0, (n, 1)).astype(np.float32)
    h[0] = 0.0   # a gated-on image with zero strength
    gate = np.array([1, 0, 0.3, 1, 0, 1, 1, 0][:n], np.float32)[:, None]
    _check_kernel_bwd(cuda_device, rgb, h, gate, g)


@pytest.mark.cuda
def test_nlmgray_backward_launches_k2_on_card(cuda_device):
    rgb, h, g = _inputs(13, 2, 64, 96, [0.3, 0.0])
    gate = torch.tensor([[1.0], [1.0]], device=cuda_device)
    x = torch.from_numpy(rgb).to(cuda_device).requires_grad_(True)
    ht = torch.from_numpy(h).to(cuda_device).requires_grad_(True)
    out = td.nlm_gray_dispatch(x, ht, gate=gate)
    assert out.grad_fn is not None
    before = build.LAUNCHES["nlm_gray_bwd"]
    out.backward(torch.from_numpy(g).to(cuda_device))
    assert build.LAUNCHES["nlm_gray_bwd"] == before + 1
    xp = torch.from_numpy(rgb).to(cuda_device).requires_grad_(True)
    hp = torch.from_numpy(h).to(cuda_device).requires_grad_(True)
    td.nlm_gray(xp, hp).backward(torch.from_numpy(g).to(cuda_device))
    torch.testing.assert_close(x.grad, xp.grad, rtol=0, atol=DRGB_ATOL)
    torch.testing.assert_close(ht.grad, hp.grad, rtol=DH_RTOL, atol=DH_ATOL)


if __name__ == "__main__":
    _build_reference(sys.argv[1], sys.argv[2])
