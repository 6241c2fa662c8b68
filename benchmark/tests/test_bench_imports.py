"""Nothing that a run loads is JAX or the JAX package; the reference loads
nothing of the port."""

import subprocess
import sys

from conftest import ROOT

from benchmark import harness


def test_top_level_names_are_compared_whole(monkeypatch):
    base = set(harness.forbidden_modules())
    for name in ("adaptiveisp_tpu_torch", "adaptiveisp_tpu_torch.api",
                 "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert set(harness.forbidden_modules()) == base
    for name in ("adaptiveisp_tpu.ops", "jaxlib.xla_client", "flax.linen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert set(harness.forbidden_modules()) == base | {
        "adaptiveisp_tpu", "jaxlib", "flax"}


def _loaded(code):
    out = subprocess.run(
        [sys.executable, "-c", "import sys\nsys.path.insert(0, %r)\n%s\n"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"
         % (str(ROOT), code)], capture_output=True, text=True, cwd=ROOT,
        timeout=300)
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_harness_and_port_load_no_jax():
    tops = _loaded(
        "from benchmark import harness\n"
        "from benchmark.drivers import infer, train\n"
        "import benchmark.control\n"
        "from adaptiveisp_tpu_torch import api\n"
        "from adaptiveisp_tpu_torch.train.trainer import Trainer\n"
        "for m in harness.load_benchmark()['per_layer']:\n"
        "    harness.metric_reader(m['name'])")
    assert not tops & set(harness.FORBIDDEN), tops & set(harness.FORBIDDEN)
    assert "adaptiveisp_tpu_torch" in tops


def test_reference_loads_nothing_of_the_port():
    tops = _loaded(
        "import pkgutil, importlib, benchmark.reference as r\n"
        "for m in pkgutil.walk_packages(r.__path__, 'benchmark.reference.'):\n"
        "    importlib.import_module(m.name)")
    assert "adaptiveisp_tpu_torch" not in tops
    assert not tops & set(harness.FORBIDDEN)
