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
                 "akka_tpu_torch.event.flight_recorder",
                 "akka_tpu_torch.event.metrics",
                 "akka_tpu_torch.config",
                 "akka_tpu_torch.tools.trace_export",
                 "akka_tpu_torch.serialization.frames",
                 "akka_tpu_torch.pattern.backoff",
                 "akka_tpu_torch.persistence",
                 "akka_tpu_torch.persistence.journal",
                 "akka_tpu_torch.persistence.tell_journal",
                 "akka_tpu_torch.persistence.entity_journal",
                 "akka_tpu_torch.persistence.slab_snapshot",
                 "akka_tpu_torch.sharding.remember",
                 "akka_tpu_torch.testkit",
                 "akka_tpu_torch.testkit.chaos",
                 "akka_tpu_torch.tools.serving_gateway",
                 # the host actor core and the bridge
                 "akka_tpu_torch.actor.actor",
                 "akka_tpu_torch.actor.cell",
                 "akka_tpu_torch.actor.deploy",
                 "akka_tpu_torch.actor.fsm",
                 "akka_tpu_torch.actor.messages",
                 "akka_tpu_torch.actor.path",
                 "akka_tpu_torch.actor.props",
                 "akka_tpu_torch.actor.provider",
                 "akka_tpu_torch.actor.ref",
                 "akka_tpu_torch.actor.scheduler",
                 "akka_tpu_torch.actor.supervision",
                 "akka_tpu_torch.actor.system",
                 "akka_tpu_torch.dispatch.batched",
                 "akka_tpu_torch.dispatch.dispatcher",
                 "akka_tpu_torch.dispatch.mailbox",
                 "akka_tpu_torch.dispatch.sysmsg",
                 "akka_tpu_torch.event.event_stream",
                 "akka_tpu_torch.event.logging",
                 "akka_tpu_torch.pattern.ask",
                 "akka_tpu_torch.pattern.circuit_breaker",
                 "akka_tpu_torch.routing.router",
                 "akka_tpu_torch.routing.routed_cell",
                 "akka_tpu_torch.serialization.serialization",
                 "akka_tpu_torch.serialization.codec",
                 "akka_tpu_torch.remote.failure_detector",
                 "akka_tpu_torch.testkit.probe",
                 "akka_tpu_torch.batched.sentinel",
                 "akka_tpu_torch.batched.bridge"):
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


# ------------------------------------------------ exports (ROADMAP C1)

EXPORT_PACKAGES = ("batched", "ops", "sharding", "gateway", "event",
                   "serialization", "testkit")


def _reference_exports(sub: str) -> set:
    """The public names akka_tpu/<sub>/__init__.py binds (akka_tpu's own
    with sub ""), read from its source: relative imports, definitions,
    assignments and __all__ (so no akka_tpu module is imported here)."""
    tree = ast.parse((ROOT / "akka_tpu" / sub / "__init__.py").read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.level >= 1:
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == "__all__":
                    names |= set(ast.literal_eval(node.value))
                elif isinstance(t, ast.Name):
                    names.add(t.id)
    return {n for n in names if not n.startswith("_") and n != "*"}


def _port_definitions(sub: str) -> set:
    """Top-level names defined anywhere in akka_tpu_torch/<sub>."""
    names = set()
    for path in (PKG / sub).rglob("*.py"):
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                names.add(node.name)
            elif isinstance(node, ast.Assign):
                names |= {t.id for t in node.targets
                          if isinstance(t, ast.Name)}
            elif isinstance(node, ast.AnnAssign) and \
                    isinstance(node.target, ast.Name):
                names.add(node.target.id)
    return names


@pytest.mark.parametrize("sub", EXPORT_PACKAGES)
def test_port_exports_what_the_reference_exports(sub):
    """Every name the reference subpackage exports and the port defines
    imports from the port's subpackage."""
    import importlib

    port = importlib.import_module(f"akka_tpu_torch.{sub}")
    shared = _reference_exports(sub) & _port_definitions(sub)
    missing = sorted(n for n in shared if not hasattr(port, n))
    assert not missing, f"akka_tpu_torch.{sub} lacks {missing}"
    if sub == "batched":
        assert {"StepCore", "ATT_WORDS", "COUNTER_NAMES", "SUP_COLUMNS",
                "decode_attention", "reply_dst"} <= shared
        from akka_tpu_torch.batched import (ATT_WORDS, COUNTER_NAMES,  # noqa
                                            SUP_COLUMNS, StepCore,
                                            decode_attention, reply_dst)
        # the bridge's names (akka_tpu/batched/__init__.py:20-22)
        bridge = {"BatchedRuntimeHandle", "DefaultCodec", "DeviceActorRef",
                  "DeviceBlockRef", "MessageCodec", "device_props",
                  "get_handle"}
        assert bridge <= shared
        assert all(hasattr(port, n) for n in bridge)


def test_package_exports_what_the_reference_package_exports():
    """Every public name akka_tpu/__init__.py binds (the actor system,
    actors, props, refs, messages, supervision, ask) imports from
    akka_tpu_torch, beside the port's own names."""
    import akka_tpu_torch

    names = _reference_exports("")
    assert {"ActorSystem", "Actor", "Props", "ask_sync",
            "OneForOneStrategy", "Terminated"} <= names
    missing = sorted(n for n in names if not hasattr(akka_tpu_torch, n))
    assert not missing, f"akka_tpu_torch lacks {missing}"
    for n in ("BatchedBehavior", "BatchedSystem", "Ctx", "Emit", "Inbox",
              "Mailbox", "behavior"):
        assert hasattr(akka_tpu_torch, n), n
