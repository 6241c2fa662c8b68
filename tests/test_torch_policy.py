"""The port's policy against the JAX package.

The full-width agent (``Config()`` defaults: 10 filters, base_channels 32,
4096 trunk features, fc1 128) is initialised in JAX, carried across with
``convert.agent_from_flax`` and run in eval mode on the same numpy inputs.
The port's ``state_dict()`` goes back through the JAX package's
``convert_agent_state_dict`` to the identical flax tree.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from adaptiveisp_tpu.config import Config as JConfig
from adaptiveisp_tpu.detect.convert import convert_agent_state_dict
from adaptiveisp_tpu.policy import states as jstates
from adaptiveisp_tpu.policy.agent import Agent as JAgent
from adaptiveisp_tpu_torch.config import Config
from adaptiveisp_tpu_torch.convert import agent_from_flax
from adaptiveisp_tpu_torch.policy import states as tstates
from adaptiveisp_tpu_torch.policy.agent import Agent
from test_torch_nlm import cheap_xla, one_torch_thread  # noqa: F401

CFG, JCFG = Config(), JConfig()


@pytest.fixture(scope="module")
def agents():
    """(flax module, flax variables as numpy, port agent in eval mode).
    The variables are seeded numpy arrays over the shapes ``init``
    declares (no compile): kernels normal with variance 1 / fan-in,
    BatchNorm scales in [0.5, 1.5], other parameters normal with scale
    0.1, and non-trivial BatchNorm statistics, so their conversion is
    load-bearing."""
    jagent = JAgent(cfg=JCFG)
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    z = jnp.zeros((1, JCFG.z_dim), jnp.float32)
    s = jnp.zeros((1, JCFG.num_state_dim), jnp.float32)
    shapes = jax.eval_shape(lambda k: jagent.init(
        {"params": k, "dropout": k}, x, z, s, 0.0, train=False),
        jax.random.PRNGKey(7))
    rng = np.random.RandomState(8)

    def fill(path, a):
        name = jax.tree_util.keystr(path)
        if name.endswith("['kernel']"):
            fan_in = int(np.prod(a.shape[:-1]))
            return (rng.randn(*a.shape) / np.sqrt(fan_in)).astype(np.float32)
        if "batch_stats" in name or name.endswith("['scale']"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (rng.randn(*a.shape) * 0.1).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(fill, shapes)
    port = Agent(CFG)
    port.load_state_dict(agent_from_flax(variables["params"],
                                         variables["batch_stats"], CFG))
    return jagent, variables, port.eval()


def _inputs(seed, n=2):
    rng = np.random.RandomState(seed)
    x = rng.uniform(0.02, 0.98, (n, 64, 64, 3)).astype(np.float32)
    z = rng.rand(n, CFG.z_dim).astype(np.float32)
    st = np.zeros((n, CFG.num_state_dim), np.float32)
    st[1, 2] = 2.0          # second sample at step 2 with two filters used
    st[1, 3 + 4] = st[1, 3 + 1] = 1.0
    return x, z, st


_JAX_FORWARD = {}


def _jax_forward(jagent, render):
    if render not in _JAX_FORWARD:
        _JAX_FORWARD[render] = jax.jit(lambda v, x, z, s, f: jagent.apply(
            v, x, z, s, 0.5, train=False, selected_filter_id=f,
            render=render))
    return _JAX_FORWARD[render]


_FORCED = [(None, "blend"), (4, "blend"), (-1, "blend"), (2, "switch")]


@pytest.mark.parametrize("forced,render", _FORCED,
                         ids=["free", "denoise", "sentinel", "switch"])
def test_agent_forward_matches_jax(agents, forced, render):
    jagent, variables, port = agents
    x, z, st = _inputs(3)
    # one compile per render mode: the forced id is a traced argument, and
    # None in the port is -1 (the sentinel) in JAX
    out_j, st_j, sur_j, pen_j, _, info_j = _jax_forward(jagent, render)(
        variables, jnp.asarray(x), jnp.asarray(z), jnp.asarray(st),
        jnp.int32(-1 if forced is None else forced))
    with torch.no_grad():
        out_t, st_t, sur_t, pen_t, hr, info_t = port(
            torch.from_numpy(x), torch.from_numpy(z), torch.from_numpy(st),
            0.5, train=False, selected_filter_id=forced, render=render)
    assert hr is None
    np.testing.assert_array_equal(info_t["selected_filter"].numpy(),
                                  np.asarray(info_j["selected_filter"]))
    # conv trunks in another summation order; pdf near 0.1: 1e-5 absolute
    np.testing.assert_allclose(info_t["pdf"].numpy(),
                               np.asarray(info_j["pdf"]), atol=1e-5)
    for p_t, p_j in zip(info_t["filter_params"], info_j["filter_params"]):
        np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), atol=1e-4)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-4)
    np.testing.assert_array_equal(st_t.numpy(), np.asarray(st_j))
    np.testing.assert_allclose(sur_t.numpy(), np.asarray(sur_j), atol=1e-4)
    np.testing.assert_allclose(pen_t.numpy(), np.asarray(pen_j), atol=1e-4)


def test_agent_requires_eval_mode_for_eval_forward(agents):
    _, _, port = agents
    x, z, st = _inputs(4)
    port.train()
    try:
        with pytest.raises(ValueError, match="train"):
            port(torch.from_numpy(x), torch.from_numpy(z),
                 torch.from_numpy(st), 1.0, train=False)
    finally:
        port.eval()


def test_state_dict_roundtrip_gives_back_flax_tree(agents):
    _, variables, port = agents
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    params, stats = convert_agent_state_dict(sd, JCFG)
    want = jax.tree_util.tree_flatten_with_path(
        {"p": variables["params"], "s": variables["batch_stats"]})[0]
    got = {jax.tree_util.keystr(k): v for k, v in
           jax.tree_util.tree_flatten_with_path({"p": params, "s": stats})[0]}
    assert len(got) == len(want)
    for k, v in want:
        np.testing.assert_array_equal(got[jax.tree_util.keystr(k)], v,
                                      err_msg=jax.tree_util.keystr(k))


def test_state_helpers_match_jax():
    rng = np.random.RandomState(9)
    pdf = rng.dirichlet(np.ones(10), 6).astype(np.float32)
    u = rng.rand(6, 1).astype(np.float32)
    np.testing.assert_array_equal(
        tstates.pdf_sample(torch.from_numpy(pdf), torch.from_numpy(u)).numpy(),
        np.asarray(jstates.pdf_sample(jnp.asarray(pdf), jnp.asarray(u))))
    img = rng.rand(2, 4, 4, 3).astype(np.float32)
    st = rng.rand(2, CFG.num_state_dim).astype(np.float32)
    np.testing.assert_array_equal(
        tstates.enrich_image_input(CFG, torch.from_numpy(img),
                                   torch.from_numpy(st)).numpy(),
        np.asarray(jstates.enrich_image_input(JCFG, jnp.asarray(img),
                                              jnp.asarray(st))))
    np.testing.assert_array_equal(
        tstates.get_noise(np.random.RandomState(1), 3, CFG.z_dim),
        jstates.get_noise(np.random.RandomState(1), 3, JCFG.z_dim))
