"""The port's test settings, in one place.

Every port test module imports the module fixtures it wants from here
(``from torch_suite import cheap_xla, one_torch_thread  # noqa: F401``),
which makes them its own.  Nothing here imports JAX at import time, so the
``cuda`` runs on a machine without JAX still collect:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/...

The settings are restored when a module ends, so none reaches a JAX
package test module that runs after it on the same worker.
"""

import contextlib
import functools
import importlib.util
import os
import subprocess
import sys

import pytest
import torch

# XLA_FLAGS of a subprocess that builds a JAX reference: what
# ``jax_disable_most_optimizations`` sets in this process
CHEAP_XLA = ("--xla_backend_optimization_level=0 "
             "--xla_llvm_disable_expensive_passes=true")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one thread while a port test module runs.  A tier-1 run
    has six workers on the host's cores, and torch's default of one
    OpenMP thread per core in each worker oversubscribes them: the port's
    test files took 1,780 s summed that way and 870 s on one thread each
    (6 workers on 8 cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _set_xla_level(cheap):
    """Sets ``jax_disable_most_optimizations``; returns its old value.  The
    flag is not part of jax's cache keys, so compiled executables are
    dropped on each change."""
    import jax

    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", cheap)
    jax.clear_caches()
    return before


@pytest.fixture(scope="module", autouse=True)
def cheap_xla():
    """XLA's cheapest CPU compile options while a port test module runs
    (``jax_disable_most_optimizations``: backend optimisation level 0, no
    expensive LLVM passes), as :data:`CHEAP_XLA` gives the subprocess
    references: the JAX references are compile-bound, and the options
    change their values by float32 rounding only.  Without JAX (the
    ``cuda`` runs) it does nothing."""
    if importlib.util.find_spec("jax") is None:
        yield
        return
    before = _set_xla_level(True)
    yield
    _set_xla_level(before)


@pytest.fixture
def full_xla():
    """XLA's default optimisation for one test of a module that runs at
    ``cheap_xla``'s level 0, for a test that misses its tolerance there."""
    before = _set_xla_level(False)
    yield
    _set_xla_level(before)


@pytest.fixture(scope="module")
def ranks_time_limit():
    """The gloo ranks a port CLI starts (``parallel.cli_mesh``, which waits
    for them with no limit) are stopped after 600 s in a test."""
    from adaptiveisp_tpu_torch import parallel

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(parallel.Ranks, "wait", functools.partialmethod(
            parallel.Ranks.wait, timeout=600))
        yield


@contextlib.contextmanager
def jax_reference(script, *args):
    """Runs ``script *args`` (a test file that builds a JAX reference when
    run as a script) in its own interpreter at :data:`CHEAP_XLA`, beside
    the tests; yields a function that waits for it (900 s at most) and
    fails with its output if it failed.  Stops it on exit."""
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(script), *map(str, args)], cwd=REPO,
        env=dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=CHEAP_XLA,
                 PYTHONPATH=REPO),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def wait():
        log = proc.communicate(timeout=900)[0]
        assert proc.returncode == 0, log

    try:
        yield wait
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
