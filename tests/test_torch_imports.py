"""The port stands alone: importing every module of ``dgc_tpu_torch`` (and
``chip_smoke.py``) loads neither JAX nor the JAX package. Checked in a
fresh interpreter, because this test process has imported both."""

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, json, pkgutil, sys
import dgc_tpu_torch, dgc_tpu_torch.train, chip_smoke
mods = [m.name for m in pkgutil.walk_packages(dgc_tpu_torch.__path__,
                                              "dgc_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
print(json.dumps({"modules": mods, "loaded": sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "dgc_tpu"))}))
"""


def _run(args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_port_imports_no_jax():
    out = _run(["-c", _PROBE], ROOT)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    for mod in ("ops.kernels", "ops.build", "ops.sparsify",
                "compression.flat", "compression.dgc", "compression.base",
                "compression.memory", "optim.distributed",
                "models.resnet_imagenet", "models.vgg",
                "data.datasets", "training.lr", "training.step", "configs",
                "interop", "training.checkpoint", "data.native",
                "parallel.multihost", "utils.logging", "utils.profiling",
                "accuracy_parity", "resilience.faults", "resilience.guard",
                "resilience.integrity", "resilience.preempt",
                "resilience.elastic", "telemetry.flight", "optim.adasum",
                "parallel.comm", "telemetry.registry", "telemetry.sink",
                "telemetry.taps", "telemetry.trace", "telemetry.attrib",
                "telemetry.fleet", "telemetry.regress",
                "resilience.adaptive", "serving", "serving.protocol",
                "serving.delta", "serving.exporter", "serving.replica",
                "resilience.surgery"):
        assert f"dgc_tpu_torch.{mod}" in res["modules"], mod
    assert res["loaded"] == []


_LAZY_PROBE = """
import json, sys
from dgc_tpu_torch.resilience import surgery
import dgc_tpu_torch.serving as serving
surgery.publish_order(sys.argv[1], "manual", 0)
before = sorted(m for m in sys.modules if m.startswith("dgc_tpu_torch."))
spec = serving.DeltaSpec
print(json.dumps({"before": before, "after": sorted(
    m for m in sys.modules if m.startswith("dgc_tpu_torch.")),
    "spec": spec.__module__}))
"""


def test_serving_package_loads_its_codecs_on_first_use(tmp_path):
    """The serving package imports its file protocol only: the surgery
    order files (a host-only reader) load none of the codecs, the flat
    engine or the kernels; ``serving.DeltaSpec`` loads them."""
    out = _run(["-c", _LAZY_PROBE, str(tmp_path / "order.json")], ROOT)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    for mod in ("serving.delta", "serving.exporter", "serving.replica",
                "compression.flat", "ops.kernels"):
        assert f"dgc_tpu_torch.{mod}" not in res["before"], mod
    assert "dgc_tpu_torch.serving.protocol" in res["before"]
    assert "dgc_tpu_torch.serving.delta" in res["after"]
    assert res["spec"] == "dgc_tpu_torch.serving.delta"


def test_chip_smoke_fails_without_a_card_or_the_package(tmp_path):
    """Without a CUDA device, and alone in a directory, the smoke script
    exits non-zero and prints no result."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    for cwd in (ROOT, str(tmp_path)):
        out = _run(["chip_smoke.py"], cwd)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
