"""Import rules of the PyTorch port: akka_tpu_torch imports neither jax nor
anything of akka_tpu, and its entry points refuse to run silently on the
CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "akka_tpu_torch"
SOURCES = sorted(p for p in PKG.rglob("*.py") if "_build" not in p.parts)
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
        ".__init__")
    for p in SOURCES)


def test_port_imports_no_jax_and_no_reference_module():
    code = (
        "import importlib, sys\n"
        f"for name in {MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'akka_tpu' or m.startswith('akka_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    for name in ("akka_tpu_torch.batched.core",
                 "akka_tpu_torch.ops.cuda_mailbox",
                 "akka_tpu_torch.batched.sharded",
                 "akka_tpu_torch.sharding.device",
                 "akka_tpu_torch.sharding.ask_batch",
                 "akka_tpu_torch.gateway.ingress",
                 "akka_tpu_torch.gateway.admission",
                 "akka_tpu_torch.gateway.aggregator",
                 "akka_tpu_torch.gateway.dedup",
                 "akka_tpu_torch.gateway.evloop",
                 "akka_tpu_torch.gateway.replica",
                 "akka_tpu_torch.gateway.slo",
                 "akka_tpu_torch.event.tracing",
                 "akka_tpu_torch.event.pressure",
                 "akka_tpu_torch.serialization.frames",
                 "akka_tpu_torch.pattern.backoff",
                 "akka_tpu_torch.tools.serving_gateway"):
        assert name in MODULES, name


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", SOURCES + [
    ROOT / "chip_smoke.py"], ids=lambda p: str(p.relative_to(ROOT)))
def test_source_has_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text(), str(path))
    for name in _imports(tree):
        root = name.split(".")[0]
        assert root != "jax", f"{path}: imports {name}"
        assert root != "akka_tpu", f"{path}: imports {name}"


def test_entry_points_need_a_card_unless_cpu_is_asked_for():
    import torch

    from akka_tpu_torch import BatchedSystem
    from akka_tpu_torch.batched.sharded import ShardedBatchedSystem
    from akka_tpu_torch.gateway import counter_behavior
    from akka_tpu_torch.models.baseline_benches import (build_cross_shard,
                                                        build_ring,
                                                        ring_behavior)
    from akka_tpu_torch.sharding import DeviceEntity, DeviceShardRegion
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    spec = DeviceEntity("c", counter_behavior(4), n_shards=2,
                        entities_per_shard=4)
    for build in (lambda **kw: BatchedSystem(capacity=8,
                                             behaviors=[ring_behavior], **kw),
                  lambda **kw: build_ring(8, **kw),
                  lambda **kw: ShardedBatchedSystem(
                      capacity=8, behaviors=[ring_behavior], n_devices=2,
                      **kw),
                  lambda **kw: build_cross_shard(2, 4, n_devices=2, **kw),
                  lambda **kw: DeviceShardRegion(spec, **kw)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
        built = build(device="cpu")
        sys_ = getattr(built, "system", built)
        assert sys_.device.type == "cpu"
