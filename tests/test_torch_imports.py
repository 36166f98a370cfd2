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
                 "akka_tpu_torch.batched.bridge",
                 # the one-card device tier and the native substrate
                 "akka_tpu_torch.routing.batched",
                 "akka_tpu_torch.ddata",
                 "akka_tpu_torch.ddata.tensor",
                 "akka_tpu_torch.stream",
                 "akka_tpu_torch.stream.device",
                 # the stream DSL's core
                 "akka_tpu_torch.stream.attributes",
                 "akka_tpu_torch.stream.stage",
                 "akka_tpu_torch.stream.interpreter",
                 "akka_tpu_torch.stream.ops",
                 "akka_tpu_torch.stream.ops2",
                 "akka_tpu_torch.stream.ops3",
                 "akka_tpu_torch.stream.restart",
                 "akka_tpu_torch.stream.ops4",
                 "akka_tpu_torch.stream.killswitch",
                 "akka_tpu_torch.stream.substreams",
                 "akka_tpu_torch.stream.dsl",
                 "akka_tpu_torch.stream.testkit",
                 # io/ and the rest of stream/
                 "akka_tpu_torch.io",
                 "akka_tpu_torch.io.tcp",
                 "akka_tpu_torch.io.udp",
                 "akka_tpu_torch.io.dns",
                 "akka_tpu_torch.stream.framing",
                 "akka_tpu_torch.stream.tcp",
                 "akka_tpu_torch.stream.context",
                 "akka_tpu_torch.stream.retry",
                 "akka_tpu_torch.stream.hub",
                 "akka_tpu_torch.stream.fileio",
                 "akka_tpu_torch.stream.streamref",
                 "akka_tpu_torch.stream.typed",
                 "akka_tpu_torch.stream.tck",
                 "akka_tpu_torch.utils.u32",
                 "akka_tpu_torch.native",
                 "akka_tpu_torch.native.lib",
                 "akka_tpu_torch.native.queues",
                 "akka_tpu_torch.native.integration",
                 # failover and the elastic mesh over shard slots
                 "akka_tpu_torch.parallel",
                 "akka_tpu_torch.parallel.mesh",
                 "akka_tpu_torch.batched.autoscale",
                 # the typed API and the host tier of persistence
                 "akka_tpu_torch.serialization.versioned",
                 "akka_tpu_torch.serialization.records",
                 "akka_tpu_torch.typed",
                 "akka_tpu_torch.typed.behavior",
                 "akka_tpu_torch.typed.behaviors",
                 "akka_tpu_torch.typed.adapter",
                 "akka_tpu_torch.typed.actor_system",
                 "akka_tpu_torch.typed.receptionist",
                 "akka_tpu_torch.typed.routers",
                 "akka_tpu_torch.typed.pubsub",
                 "akka_tpu_torch.typed.delivery",
                 "akka_tpu_torch.persistence.messages",
                 "akka_tpu_torch.persistence.snapshot",
                 "akka_tpu_torch.persistence.persistence",
                 "akka_tpu_torch.persistence.eventsourced",
                 "akka_tpu_torch.persistence.at_least_once",
                 "akka_tpu_torch.persistence.adapter",
                 "akka_tpu_torch.persistence.typed",
                 "akka_tpu_torch.persistence.query",
                 "akka_tpu_torch.persistence.testkit",
                 # remoting and cluster membership
                 "akka_tpu_torch.utils.hashing",
                 "akka_tpu_torch.pki",
                 "akka_tpu_torch.pki.pem",
                 "akka_tpu_torch.remote",
                 "akka_tpu_torch.remote.transport",
                 "akka_tpu_torch.remote.instrument",
                 "akka_tpu_torch.remote.provider",
                 "akka_tpu_torch.remote.deploy",
                 "akka_tpu_torch.cluster",
                 "akka_tpu_torch.cluster.vector_clock",
                 "akka_tpu_torch.cluster.member",
                 "akka_tpu_torch.cluster.reachability",
                 "akka_tpu_torch.cluster.gossip",
                 "akka_tpu_torch.cluster.events",
                 "akka_tpu_torch.cluster.daemon",
                 "akka_tpu_torch.cluster.sbr",
                 "akka_tpu_torch.cluster.cluster",
                 "akka_tpu_torch.cluster.routing",
                 # replicated state and cluster tools
                 "akka_tpu_torch.ddata.version_vector",
                 "akka_tpu_torch.ddata.crdt",
                 "akka_tpu_torch.ddata.durable",
                 "akka_tpu_torch.ddata.replicator",
                 "akka_tpu_torch.cluster_tools",
                 "akka_tpu_torch.cluster_tools.lease",
                 "akka_tpu_torch.cluster_tools.discovery",
                 "akka_tpu_torch.cluster_tools.pubsub",
                 "akka_tpu_torch.cluster_tools.singleton",
                 "akka_tpu_torch.cluster_tools.client",
                 "akka_tpu_torch.cluster_tools.metrics",
                 # the host tier of sharding and the rest of testkit
                 "akka_tpu_torch.sharding.messages",
                 "akka_tpu_torch.sharding.coordinator",
                 "akka_tpu_torch.sharding.region",
                 "akka_tpu_torch.sharding.sharding",
                 "akka_tpu_torch.sharding.typed",
                 "akka_tpu_torch.sharding.daemon_process",
                 "akka_tpu_torch.testkit.behavior_testkit",
                 "akka_tpu_torch.testkit.dilation",
                 "akka_tpu_torch.testkit.event_filter",
                 "akka_tpu_torch.testkit.manual_time",
                 "akka_tpu_torch.testkit.multi_node",
                 "akka_tpu_torch.testkit.multi_process",
                 "akka_tpu_torch.testkit.sharding"):
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
    from akka_tpu_torch.sharding import (ClusterShardingTyped, DeviceEntity,
                                         DeviceShardRegion)
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
                  lambda **kw: DeviceShardRegion(spec, **kw),
                  # the typed facade's device entry point, over a system
                  # stub: init_device starts nothing of the actor system
                  lambda **kw: ClusterShardingTyped.get(
                      _ExtensionHost()).init_device(spec, **kw)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
        built = build(device="cpu")
        sys_ = getattr(built, "system", built)
        assert sys_.device.type == "cpu"


class _ExtensionHost:
    """Stands in for an ActorSystem where only extensions are made."""

    def register_extension(self, ext):
        return ext.create_extension(self)


# ------------------------------------------------ exports (ROADMAP C1)

EXPORT_PACKAGES = ("batched", "ops", "sharding", "gateway", "event",
                   "serialization", "testkit", "typed", "persistence",
                   "pki", "cluster", "remote", "stream", "io")


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


# ------------------------------- public names of ported modules (C2)

# Reference modules the port has no file for yet, by the item that ports
# them: a name a reference __init__ imports from one of them is excepted.
# Every module is ported (NOT_A_FILE, test_every_reference_module_has_a_file).
UNPORTED_MODULES: dict = {}

# Public names of ported reference files that the port's file lacks, by
# the item that ports them.
UNPORTED_NAMES = {
    ("batched/bridge.py", "I32"): "for good: a jnp dtype",
    ("batched/bridge.py", "F32"): "for good: a jnp dtype",
}


def _public_surface(path: Path):
    """(names, {class: methods}, {name: source module}) a module binds at
    its top level, read by AST: definitions, assignments, __all__ and, in
    a package's __init__, its relative imports (its exports) with the
    module each comes from."""
    tree = ast.parse(path.read_text())
    names, classes, sources = set(), {}, {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(node.name)
        elif isinstance(node, ast.ClassDef):
            names.add(node.name)
            classes[node.name] = {
                n.name for n in node.body
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                and not n.name.startswith("_")}
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                for e in (t.elts if isinstance(t, ast.Tuple) else [t]):
                    if isinstance(e, ast.Name) and e.id != "__all__":
                        names.add(e.id)
                if isinstance(t, ast.Name) and t.id == "__all__":
                    names |= set(ast.literal_eval(node.value))
        elif isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif isinstance(node, ast.ImportFrom) and node.level >= 1 and \
                path.name == "__init__.py":
            for a in node.names:
                name = a.asname or a.name
                names.add(name)
                sources[name] = node.module
    return ({n for n in names if not n.startswith("_")}, classes, sources)


def _port_binds(path: Path) -> set:
    """Every top-level name the port's file binds, imports included."""
    names, _, _ = _public_surface(path)
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return names


PORTED_FILES = sorted(
    str(p.relative_to(ROOT / "akka_tpu"))
    for p in (ROOT / "akka_tpu").rglob("*.py")
    if (PKG / p.relative_to(ROOT / "akka_tpu")).exists())


def _excepted(rel: str, name: str, source) -> bool:
    if (rel, name) in UNPORTED_NAMES:
        return True
    if source is None:
        return False
    pkg = os.path.dirname(rel)
    mod = f"{pkg}/{source.replace('.', '/')}.py" if pkg else \
        f"{source.replace('.', '/')}.py"
    return mod in UNPORTED_MODULES or (mod, name) in UNPORTED_NAMES


@pytest.mark.parametrize("rel", PORTED_FILES)
def test_ported_file_has_the_references_public_names(rel):
    """For every reference module with a file in the port: each public
    top-level name of the reference's file, and each public method of its
    classes, is in the port's file, except the names the lists above
    give to a later item."""
    ref_names, ref_classes, sources = _public_surface(ROOT / "akka_tpu" / rel)
    port_path = PKG / rel
    have = _port_binds(port_path)
    _, port_classes, _ = _public_surface(port_path)
    missing = sorted(n for n in ref_names - have
                     if not _excepted(rel, n, sources.get(n)))
    assert not missing, f"akka_tpu_torch/{rel} lacks {missing}"
    for cls, methods in ref_classes.items():
        if cls.startswith("_") or _excepted(rel, cls, None):
            continue
        if cls not in port_classes:
            continue  # a name imported from elsewhere: checked there
        lacking = sorted(methods - port_classes[cls])
        assert not lacking, f"akka_tpu_torch/{rel} {cls} lacks {lacking}"


# reference modules with no file of the same path in the port, and why
NOT_A_FILE = {
    "ops/pallas_mailbox.py": "the TPU kernel: csrc/ring_mailbox.cu",
    "utils/platform.py": "not to port (TPU platform probing)",
}


def test_every_reference_module_has_a_file():
    """The port has a file for every module of akka_tpu/, but the Pallas
    kernel's (ported as CUDA) and the TPU platform probe; the CUDA source
    that replaces the kernel is there."""
    ref = {str(p.relative_to(ROOT / "akka_tpu"))
           for p in (ROOT / "akka_tpu").rglob("*.py")
           if "_build" not in p.parts}
    missing = sorted(r for r in ref if not (PKG / r).exists())
    assert missing == sorted(NOT_A_FILE), missing
    assert (PKG / "csrc" / "ring_mailbox.cu").exists()


def test_exception_lists_name_only_later_items():
    """The only exceptions left are the jnp dtypes; they name no module
    the port has a file for, and no name the port has. A10.2 (the
    distributed init and its config hook), A12.1 (the typed API and the
    host tier of persistence), A12.2 (remoting, PKI and cluster
    membership), A12.3 (ddata's replicator and CRDTs, cluster_tools),
    A12.4 (the host tier of sharding, the rest of testkit) and A12.5 (the
    stream DSL, io/ and the rest of stream/) are ported: no label of
    theirs is left, no source of the port names A12.2 or A12.5, and no
    test or chip script names A12.2."""
    labels = set(UNPORTED_MODULES.values()) | set(UNPORTED_NAMES.values())
    assert labels <= {"for good: a jnp dtype"}, labels
    assert not labels & {"A10.2", "A12.1", "A12.2", "A12.3", "A12.4",
                         "A12.5"}, labels
    assert not UNPORTED_MODULES
    for path in SOURCES:
        assert "A12.5" not in path.read_text(), path
    for path in SOURCES + sorted(ROOT.glob("tests/*torch_*.py")) + [
            ROOT / "chip_smoke.py"]:
        if path.name != "test_torch_imports.py":
            assert "A12.2" not in path.read_text(), path
    for mod in UNPORTED_MODULES:
        assert (ROOT / "akka_tpu" / mod).exists(), mod
        assert not (PKG / mod).exists(), f"{mod} is ported: drop it"
    for rel, name in UNPORTED_NAMES:
        assert name not in _port_binds(PKG / rel), f"{rel} {name} ported"
    assert "models/baseline_benches.py" not in {r for r, _ in UNPORTED_NAMES}
    assert "batched/metrics_slab.py" not in {r for r, _ in UNPORTED_NAMES}
    for rel in ("typed/behavior.py", "typed/delivery.py",
                "persistence/typed.py", "persistence/journal.py",
                "persistence/query.py", "serialization/versioned.py",
                "pattern/backoff.py",
                "routing/batched.py", "ddata/tensor.py", "stream/device.py",
                "batched/sentinel.py", "batched/autoscale.py",
                "parallel/mesh.py", "native/lib.py", "native/queues.py",
                "native/integration.py", "batched/metrics_slab.py",
                "models/baseline_benches.py", "utils/hashing.py",
                "pki/pem.py", "remote/transport.py", "remote/instrument.py",
                "remote/provider.py", "remote/deploy.py",
                "cluster/daemon.py", "cluster/sbr.py", "cluster/cluster.py",
                "cluster/routing.py", "ddata/version_vector.py",
                "ddata/crdt.py", "ddata/durable.py", "ddata/replicator.py",
                "cluster_tools/__init__.py", "cluster_tools/lease.py",
                "cluster_tools/discovery.py", "cluster_tools/pubsub.py",
                "cluster_tools/singleton.py", "cluster_tools/client.py",
                "cluster_tools/metrics.py", "sharding/messages.py",
                "sharding/coordinator.py", "sharding/region.py",
                "sharding/sharding.py", "sharding/typed.py",
                "sharding/daemon_process.py", "testkit/behavior_testkit.py",
                "testkit/dilation.py", "testkit/event_filter.py",
                "testkit/manual_time.py", "testkit/multi_node.py",
                "testkit/multi_process.py", "testkit/sharding.py",
                "stream/attributes.py", "stream/stage.py",
                "stream/interpreter.py", "stream/ops.py", "stream/ops2.py",
                "stream/ops3.py", "stream/restart.py", "stream/ops4.py",
                "stream/killswitch.py", "stream/substreams.py",
                "stream/dsl.py", "stream/testkit.py",
                "io/__init__.py", "io/tcp.py", "io/udp.py", "io/dns.py",
                "stream/framing.py", "stream/tcp.py", "stream/context.py",
                "stream/retry.py", "stream/hub.py", "stream/fileio.py",
                "stream/streamref.py", "stream/typed.py", "stream/tck.py",
                "stream/__init__.py"):
        assert rel in PORTED_FILES, rel


def _config_strings(node):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _config_strings(k)
            yield from _config_strings(v)
    elif isinstance(node, (list, tuple)):
        for v in node:
            yield from _config_strings(v)
    elif isinstance(node, str):
        yield node


def test_default_config_names_no_module_of_the_reference():
    """No string of the port's default config names a module under
    akka_tpu: the persistence plugins' classes are the port's own."""
    import importlib

    from akka_tpu_torch.config import reference_config

    cfg = reference_config()
    strings = list(_config_strings(cfg.to_dict()))
    assert strings
    bad = [s for s in strings if s == "akka_tpu" or
           s.startswith("akka_tpu.")]
    assert not bad, bad
    for path, want in (
            ("akka.persistence.journal.inmem.class",
             "akka_tpu_torch.persistence.journal.InMemJournal"),
            ("akka.persistence.journal.file.class",
             "akka_tpu_torch.persistence.journal.FileJournal"),
            ("akka.persistence.snapshot-store.local.class",
             "akka_tpu_torch.persistence.snapshot.LocalSnapshotStore")):
        assert cfg.get_string(path) == want
        module, _, name = want.rpartition(".")
        assert hasattr(importlib.import_module(module), name), want


def test_metrics_slab_host_helpers_match_the_reference():
    """The four names of ROADMAP C2's first item, bit-identical to the
    reference on the same numpy inputs (tests/test_metrics.py:31-79)."""
    import numpy as np

    from akka_tpu.batched import metrics_slab as jm
    from akka_tpu_torch.batched import metrics_slab as tm
    rng = np.random.default_rng(9)
    v = np.concatenate([np.array([-5, 0, 1, 2, 3, 4, 7, 8, 2**14 - 1,
                                  2**14, 2**20, 2**31 - 1]),
                        rng.integers(-10, 1 << 16, 52)])
    got = tm.bucket_of_np(v)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, jm.bucket_of_np(v))
    mask = rng.random(v.shape[0]) < 0.6
    got = tm.masked_hist_np(v, mask)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, jm.masked_hist_np(v, mask))
    slab = rng.integers(0, 1000, (3, tm.N_HIST, tm.N_BUCKETS)) \
        .astype(np.int32)
    for s in (slab, slab[0]):
        want = jm.slab_totals(s)
        got = tm.slab_totals(s)
        assert got.dtype == want.dtype == np.int64
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(tm.slab_totals(
            __import__("torch").from_numpy(s)), want)
    assert [tm.bucket_label(i) for i in range(tm.N_BUCKETS)] == \
        [jm.bucket_label(i) for i in range(jm.N_BUCKETS)]
