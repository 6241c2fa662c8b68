"""The port's spatially sharded render (sp), expert-parallel blend (ep)
and pipelined render (pp) against the JAX package's on the CPU.

Four gloo ranks start once for the module (``torch_axes_ranks.py``:
spawned ranks import it by name) and run every scenario on (2 x 2)
meshes, sp also on (1 x 4), one torch thread each, while JAX computes its
references on conftest's virtual CPU devices:
  * sp: JAX's ``make_sharded_render`` on a (2 x 2) mesh at 64 x 64 with a
    ``denoise`` stage (circular 7-row halo) and ``sharpen`` (the frame's
    own edge rows), and an uneven height (61 rows: blocks of 31 and 30, or
    16, 16, 16 and 13), which JAX's sharded jit refuses, against JAX's
    single-device ``render_pipeline(allow_fused=False)``, to 1e-6
    (``tests/test_spatial_sharding.py``); every rank's gathered frames;
  * ep: ``make_ep_blend_render`` on (2 x 2) with one-hot weights (two
    images on ``denoise``) and soft weights, to 1e-5 relative and 1e-6
    absolute (``tests/test_ep_pp.py``), on a four-filter roster with
    ``denoise`` (JAX's switch over Config()'s ten branches takes 28 s to
    compile here);
  * pp: ``make_pipelined_render`` on (2 x 2), 5 microbatches, to 1e-6;
and the refusals: a block shorter than a halo, masking and indivisible
experts under ep, a stage count that differs from the pipe size.  The
module has fewer tests than ``test_pallas_nlm.py``, so a tier-1 run
starts it after that file, beside it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptiveisp_tpu.config import Config as JConfig
from adaptiveisp_tpu.ops import bank as jbank
from adaptiveisp_tpu.ops.ep import make_ep_blend_render as jep
from adaptiveisp_tpu.ops.pp import make_pipelined_render as jpp
from adaptiveisp_tpu.train import mesh as jmesh
from test_torch_nlm import cheap_xla, one_torch_thread  # noqa: F401
import torch_axes_ranks

SP_NAMES = ["exposure", "improved_wb", "ccm", "gamma", "denoise", "sharpen"]
EP_FILTERS = ("exposure", "denoise", "sharpen", "gamma")
EP_CFG = dict(filters=EP_FILTERS, filters_runtime=(1.7, 5.0, 2.0, 2.0))
PP_NAMES = ["exposure", "sharpen"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four ranks' outputs (started first) and JAX's references,
    computed while the ranks run."""
    root = tmp_path_factory.mktemp("axes")
    rng = np.random.RandomState(23)
    cfg = JConfig()

    def params(names, n):
        return [(rng.rand(n, jbank.get_spec(cfg, k).n_params)
                 .astype(np.float32) * 2 - 1) for k in names]

    sp_cases = {h: (rng.rand(2, h, 64, 3).astype(np.float32),
                    params(SP_NAMES, 2)) for h in (64, 61)}
    ecfg = JConfig(**EP_CFG)
    img = rng.rand(4, 32, 32, 3).astype(np.float32)
    eparams = [(rng.rand(4, s.n_params).astype(np.float32) * 2 - 1)
               for s in jbank.filter_specs(ecfg)]
    onehot = np.eye(4, dtype=np.float32)[[1, 3, 1, 0]]
    soft = rng.rand(4, 4).astype(np.float32)
    soft /= soft.sum(1, keepdims=True)
    ep_cases = {"onehot": (img, eparams, onehot),
                "soft": (img, eparams, soft)}
    pp_frames = rng.rand(5, 2, 32, 32, 3).astype(np.float32)
    pp_params = [(rng.rand(jbank.get_spec(cfg, k).n_params)
                  .astype(np.float32) * 2 - 1) for k in PP_NAMES]
    torch.save(dict(
        sp_meshes={"2x2": (2, 2), "1x4": (1, 4)}, sp_names=SP_NAMES,
        sp_cases=sp_cases, ep_cfg=EP_CFG, ep_cases=ep_cases,
        pp_names=PP_NAMES, pp_frames=pp_frames, pp_params=pp_params),
        root / "inputs.pt")
    ranks = torch_axes_ranks.launch(root, "axes_scenarios")

    want = {}
    j = [jnp.asarray(p) for p in sp_cases[64][1]]
    want["sp", 64] = np.asarray(jbank.make_sharded_render(
        cfg, jmesh.make_mesh_2d(2, 2), SP_NAMES)(
            jnp.asarray(sp_cases[64][0]), j))
    im, p = sp_cases[61]
    want["sp", 61] = np.asarray(jax.jit(
        lambda x, ps: jbank.render_pipeline(cfg, x, list(zip(SP_NAMES, ps)),
                                            allow_fused=False))(
        jnp.asarray(im), [jnp.asarray(q) for q in p]))
    fn = jep(ecfg, jmesh.make_mesh_dp_ep(2, 2))
    for name, (x, ps, w) in ep_cases.items():
        want["ep", name] = np.asarray(fn(
            jnp.asarray(x), [jnp.asarray(q) for q in ps], jnp.asarray(w)))
    want["pp"] = np.asarray(jpp(cfg, jmesh.make_mesh_dp_pp(2, 2), PP_NAMES)(
        jnp.asarray(pp_frames), [jnp.asarray(q) for q in pp_params]))
    return dict(ranks=ranks(), want=want)


# --------------------------------------------------------------- sp ----
@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
def test_sharded_render_matches_jax(runs, mesh):
    """Each rank's block and gathered frames against JAX's sharded render
    (64 rows) or JAX's single-device render (61 rows, which JAX's sharded
    jit refuses); the blocks are ceil(H / n) rows, the last ones
    shorter."""
    n_spatial = int(mesh.split("x")[1])
    for height in (64, 61):
        want = runs["want"]["sp", height]
        seen = set()
        for r in runs["ranks"]:
            got = r["sp"][mesh, height]
            rows, (lo, hi) = got["rows"], got["bounds"]
            np.testing.assert_allclose(got["frames"].numpy(), want[rows],
                                       rtol=1e-6, atol=1e-6)
            np.testing.assert_array_equal(got["block"].numpy(),
                                          got["frames"][:, lo:hi].numpy())
            seen.add((lo, hi))
        per = -(-height // n_spatial)
        assert sorted(seen) == [(i * per, min(height, (i + 1) * per))
                                for i in range(n_spatial)]


# --------------------------------------------------------------- ep ----
@pytest.mark.parametrize("weights", ["onehot", "soft"])
def test_ep_blend_matches_jax(runs, weights):
    want = runs["want"]["ep", weights]
    for r in runs["ranks"]:
        got = r["ep"][weights]
        np.testing.assert_allclose(got["out"].numpy(), want[got["rows"]],
                                   rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------- pp ----
def test_pipelined_render_matches_jax(runs):
    """The last pipe rank of each data row holds its rows of every
    microbatch; the first holds nothing."""
    want = runs["want"]["pp"]
    outs = [r["pp"] for r in runs["ranks"]]
    assert [o["out"] is None for o in outs] == [True, False, True, False]
    for o in outs[1::2]:
        np.testing.assert_allclose(o["out"].numpy(), want[:, o["rows"]],
                                   rtol=1e-6, atol=1e-6)


# --------------------------------------------------------- refusals ----
def test_refusals(runs):
    """A block shorter than a stage's halo, masking and indivisible
    experts under ep, a stage count that differs from the pipe size."""
    for r in runs["ranks"]:
        assert "a stage needs 7" in r["sp"]["2x2", "short"]
        assert "block of 3 rows" in r["sp"]["1x4", "short"]
        assert "masking" in r["ep"]["masking"]
        assert r["ep"]["indivisible"] == ("10 filters do not tile over 4 "
                                          "experts")
        assert "3 stages need a pipe axis of 3" in r["pp"]["mismatch"]
