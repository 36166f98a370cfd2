"""Remote deployment: create an actor ON another node from a local Props.

A copy of `akka_tpu/remote/deploy.py` at commit 56e9e23 (host code, no jax;
the port keeps its own copy of every module it needs). One repair: the
daemon remembers the names of its deployed children that stopped (as it
does those whose creation failed, for as long), and answers a Watch of
such a child, and a Watch still buffered when its child's creation
deadline passes, with `Terminated(existence_confirmed=False)`, as Akka
answers a Watch of a dead actor. The reference drops both to dead
letters, so the watcher never learns that the actor is gone.

Reference parity: akka-remote/src/main/scala/akka/remote/
RemoteActorRefProvider.scala:152 (actorOf consults the deployer; a
RemoteScope deploy routes creation through the remote daemon),
RemoteDeployer.scala (parses `remote = "akka://sys@host:port"` deployment
config), and RemoteDaemon (remote/RemoteActorRefProvider.scala RemoteDeadLetterActorRef
sibling — the `/remote` guardian that instantiates DaemonMsgCreate payloads,
remote/RemoteSystemDaemon semantics).

TPU-first deviations, by design:
- Props travel as a *recipe* (module-qualified class + codec-encoded ctor
  args), never as pickled closures — consistent with the fixed-schema wire
  (serialization/codec.py). Classes must be registered deployable on the
  target (register_deployable) unless the node opts into trusted mode
  (`akka.remote.allow-pickle = true`, mirroring the reference's
  untrusted-mode gate, remote/RemoteActorRefProvider.scala untrusted checks).
- The deployed actor is supervised by the target's remote daemon (restart on
  failure per its strategy); the deploying parent observes lifecycle via
  remote DeathWatch. The reference instead proxies Supervise/Failed over the
  wire; collapsing that round-trip keeps supervision local to the data.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

from ..actor.actor import Actor
from ..actor.deploy import Deploy, RemoteScope
from ..actor.messages import DeadLetter, Terminated
from ..actor.path import Address
from ..actor.props import Props
from ..serialization.codec import register_wire_class

_DEPLOYABLE: Dict[str, type] = {}
_DEPLOYABLE_LOCK = threading.Lock()


def register_deployable(cls: type) -> type:
    """Mark an Actor class as instantiable by remote DaemonMsgCreate on this
    node. Usable as a decorator. Also registers the class key both ways."""
    key = f"{cls.__module__}:{cls.__qualname__}"
    with _DEPLOYABLE_LOCK:
        _DEPLOYABLE[key] = cls
    return cls


def _class_key(cls: type) -> str:
    return f"{cls.__module__}:{cls.__qualname__}"


def _resolve_deployable(key: str, allow_import: bool) -> type:
    with _DEPLOYABLE_LOCK:
        cls = _DEPLOYABLE.get(key)
    if cls is not None:
        return cls
    if not allow_import:
        raise PermissionError(
            f"refusing to deploy unregistered class {key!r}: call "
            "register_deployable on the target node (or enable "
            "akka.remote.allow-pickle for trusted links)")
    module, _, qualname = key.partition(":")
    import importlib
    obj: Any = importlib.import_module(module)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    if not isinstance(obj, type):
        raise TypeError(f"deploy key {key!r} did not resolve to a class")
    return obj


@register_wire_class
@dataclass(frozen=True)
class DaemonMsgCreate:
    """The wire recipe for a remote spawn (reference:
    remote/DaemonMsgCreateSerializer.scala — class + args + deploy + path)."""
    class_key: str
    args: tuple
    kwargs: tuple                 # sorted (name, value) items
    child_name: str               # daemon-local (mangled) child name
    origin_path: str              # full origin-side path, for diagnostics
    dispatcher: Optional[str] = None
    mailbox: Optional[str] = None


@register_wire_class
@dataclass(frozen=True)
class DaemonMsgCreateFailed:
    child_name: str
    reason: str


@dataclass(frozen=True)
class _DeliverToChild:
    """Local-only wrapper: an inbound message that raced the child's
    creation (transport delivered it before the daemon's mailbox processed
    DaemonMsgCreate). The daemon buffers until the child exists — the remote
    analogue of mailbox-before-Create buffering (dungeon/Dispatch.scala:63-100
    enqueues Create before any user message can run). `system` marks system
    messages (Watch/Unwatch/Terminate), which must not be lost either."""
    child_name: str
    message: Any
    sender: Any
    system: bool = False


def mangle(origin_path: str) -> str:
    """Deterministic daemon-child name for a deployed actor: both ends derive
    it from the origin-side path (reference: RemoteActorRefProvider gives
    deployed actors paths under /remote/<protocol>/<origin-addr>/...).
    urlsafe-base64 so the name stays a single valid path element."""
    import base64
    return base64.urlsafe_b64encode(origin_path.encode()).decode().rstrip("=")


def deployed_path_for(remote_address: Address, origin_path: str):
    """The full path of the actor once deployed at `remote_address`."""
    from ..actor.path import ActorPath
    return ActorPath(remote_address) / "remote" / mangle(origin_path)


class RemoteSystemDaemon(Actor):
    """Lives at /remote on every remote-enabled system; instantiates
    DaemonMsgCreate recipes as supervised children (reference:
    RemoteSystemDaemon in remote/RemoteActorRefProvider.scala)."""

    MAX_BUFFERED_PER_CHILD = 1000

    def __init__(self, provider):
        super().__init__()
        self.provider = provider
        self._pending: Dict[str, list] = {}   # child_name -> early messages
        self._failed: Dict[str, str] = {}     # child_name -> reason
        self._stopped: set = set()            # names of stopped children
        # origin parent path -> daemon-child names whose life is tied to it
        self._parent_children: Dict[str, set] = {}

    @property
    def supervisor_strategy(self):
        from ..actor.supervision import OneForOneStrategy, default_decider
        return OneForOneStrategy(decider=default_decider)

    def receive(self, message: Any):
        if isinstance(message, DaemonMsgCreate):
            self._create(message)
        elif isinstance(message, _DeliverToChild):
            self._deliver(message)
        elif isinstance(message, tuple) and message and message[0] == "drop-pending":
            for m, snd, sys_ in self._pending.pop(message[1], ()):
                self._reject(message[1], m, snd, sys_)
        elif isinstance(message, tuple) and message and message[0] == "drop-failed":
            # failure records only need to live long enough to dead-letter
            # in-flight sends; on a long-lived node they must not accumulate
            self._failed.pop(message[1], None)
        elif isinstance(message, tuple) and message and message[0] == "drop-stopped":
            self._stopped.discard(message[1])
        elif isinstance(message, tuple) and message and message[0] == "origin-parent-died":
            for name in self._parent_children.pop(message[1], ()):
                child = self.context.child(name)
                if child is not None:
                    self.context.stop(child)
        elif isinstance(message, Terminated):
            # one of OUR children stopped: drop life-cycle bookkeeping, and
            # once an origin parent has no deployed children left, unwatch it
            # and drop its (now empty) entry
            name = message.actor.path.name
            if self.context.child(name) is None:
                # remembered as long as a failure is: a Watch that races
                # the stop is answered, not buffered
                self._stopped.add(name)
                me = self.self_ref
                self.context.system.scheduler.schedule_once(
                    5.0, lambda: me.tell(("drop-stopped", name)))
            for parent, kids in list(self._parent_children.items()):
                kids.discard(name)
                if not kids:
                    del self._parent_children[parent]
                    parent_ref = self.provider.resolve_actor_ref(parent)
                    if parent_ref is not self.provider.dead_letters:
                        self.context.unwatch(parent_ref)
        else:
            return NotImplemented
        return None

    @staticmethod
    def _send_to(child, message, sender, system: bool) -> None:
        from ..dispatch import sysmsg as _sysmsg
        from .provider import _RemoteTerminate
        if isinstance(message, _RemoteTerminate):
            child.stop()
        elif system and isinstance(message, _sysmsg.SystemMessage):
            if isinstance(message, (_sysmsg.Watch, _sysmsg.Unwatch)):
                # a Watch that raced the deploy deserialized its watchee ref
                # BEFORE the child existed → dead letters; by protocol the
                # watchee of a Watch delivered to child X is X, so re-point
                import dataclasses
                message = dataclasses.replace(message, watchee=child)
            child.send_system_message(message)
        else:
            child.tell(message, sender)

    def _deliver(self, msg: _DeliverToChild) -> None:
        child = self.context.child(msg.child_name)
        if child is not None:
            self._send_to(child, msg.message, msg.sender, msg.system)
            return
        if msg.child_name in self._failed or msg.child_name in self._stopped:
            self._reject(msg.child_name, msg.message, msg.sender, msg.system)
            return
        # creation may still be in flight (unordered transport); buffer with
        # a deadline after which unclaimed messages become dead letters
        buf = self._pending.get(msg.child_name)
        if buf is None:
            buf = self._pending[msg.child_name] = []
            me, name = self.self_ref, msg.child_name
            self.context.system.scheduler.schedule_once(
                5.0, lambda: me.tell(("drop-pending", name)))
        if len(buf) >= self.MAX_BUFFERED_PER_CHILD:
            self.context.system.event_stream.publish(
                DeadLetter(msg.message, msg.sender, self.self_ref))
        else:
            buf.append((msg.message, msg.sender, msg.system))

    def _reject(self, child_name: str, message, sender, system: bool) -> None:
        """A message for a child that does not exist: a Watch is answered
        with Terminated(existence_confirmed=False), anything else goes to
        dead letters."""
        from ..actor.ref import MinimalActorRef
        from ..dispatch import sysmsg as _sysmsg
        if system and isinstance(message, _sysmsg.Watch) \
                and message.watcher is not None:
            gone = MinimalActorRef(self.self_ref.path / child_name,
                                   self.provider)
            message.watcher.send_system_message(
                _sysmsg.DeathWatchNotification(gone,
                                               existence_confirmed=False))
            return
        self.context.system.event_stream.publish(
            DeadLetter(message, sender, self.self_ref))

    def _create(self, msg: DaemonMsgCreate) -> None:
        allow_import = self.provider.serialization.allow_pickle
        try:
            cls = _resolve_deployable(msg.class_key, allow_import)
            props = Props.create(cls, *msg.args, **dict(msg.kwargs))
            if msg.dispatcher:
                props = props.with_dispatcher(msg.dispatcher)
            if msg.mailbox:
                props = props.with_mailbox(msg.mailbox)
            existing = self.context.child(msg.child_name)
            if existing is not None:
                return  # idempotent re-delivery
            child = self.context.actor_of(props, msg.child_name)
            self._stopped.discard(msg.child_name)
            self.context.watch(child)
            # tie the child's life to its origin-side parent: when the parent
            # (or its whole node) dies, stop the orphans (the reference keeps
            # parent supervision over the wire; we collapse it to deathwatch).
            # One watch per distinct parent — cell.watch would overwrite a
            # per-child watchWith message for an already-watched ref.
            origin_parent = msg.origin_path.rsplit("/", 1)[0]
            kids = self._parent_children.get(origin_parent)
            if kids is None:
                kids = self._parent_children[origin_parent] = set()
                parent_ref = self.provider.resolve_actor_ref(origin_parent)
                if parent_ref is not self.provider.dead_letters:
                    self.context.watch(
                        parent_ref,
                        message=("origin-parent-died", origin_parent))
            kids.add(msg.child_name)
            for m, snd, sys_ in self._pending.pop(msg.child_name, ()):
                self._send_to(child, m, snd, sys_)
            fr = getattr(self.context.system, "flight_recorder", None)
            if fr is not None:
                fr.event("remote_deploy", child=str(child.path),
                         origin=msg.origin_path)
        except Exception as e:  # noqa: BLE001 — report, don't kill the daemon
            self._failed[msg.child_name] = repr(e)
            me, name = self.self_ref, msg.child_name
            self.context.system.scheduler.schedule_once(
                5.0, lambda: me.tell(("drop-failed", name)))
            for m, snd, sys_ in self._pending.pop(msg.child_name, ()):
                self._reject(msg.child_name, m, snd, sys_)
            self.context.system.event_stream.publish(DeadLetter(
                DaemonMsgCreateFailed(msg.child_name, repr(e)),
                None, self.self_ref))
            if self.sender is not None:
                self.sender.tell(DaemonMsgCreateFailed(msg.child_name, repr(e)),
                                 self.self_ref)


def remote_deploy(provider, props: Props, path, deploy: Deploy):
    """Origin-side half: ship the recipe, return the remote ref immediately
    (the reference's actorOf does the same — the RemoteActorRef exists before
    the remote child does; early tells buffer in transit)."""
    if props.router_config is not None:
        raise ValueError(
            "deploying a router remotely is not supported; deploy routees "
            "remotely instead (cluster/routing.py ClusterRouterPool)")
    if not props.has_recipe:
        raise ValueError(
            "remote deployment needs Props.create(cls, *args) — a factory "
            "closure cannot travel to another node")
    addr = Address.parse(deploy.scope.address)
    origin = path.with_address(provider.local_address).to_serialization_format()
    msg = DaemonMsgCreate(
        class_key=_class_key(props.cls), args=props.args, kwargs=props.kwargs,
        child_name=mangle(origin), origin_path=origin,
        dispatcher=props.dispatcher,
        mailbox=props.mailbox if isinstance(props.mailbox, str) else None)
    daemon = provider.resolve_actor_ref(f"akka://{addr.system}@{addr.host}:"
                                        f"{addr.port}/remote")
    daemon.tell(msg)
    target_path = deployed_path_for(addr, origin)
    from .provider import RemoteActorRef
    return RemoteActorRef(target_path, provider)
