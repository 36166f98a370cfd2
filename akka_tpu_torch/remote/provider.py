"""RemoteActorRefProvider: location transparency across systems.

A copy of `akka_tpu/remote/provider.py` at commit 56e9e23 (host code, no jax;
the port keeps its own copy of every module it needs).

Reference parity: akka-remote/src/main/scala/akka/remote/
RemoteActorRefProvider.scala (:152 wraps LocalActorRefProvider; RemoteActorRef
tell -> remote.send :651,732), ArteryTransport association model
(artery/Association.scala: per-peer state, quarantine :290-314), system-message
reliability (artery/SystemMessageDelivery.scala: seq + cumulative ack +
resend), RemoteWatcher (remote/RemoteWatcher.scala:34-88: heartbeats +
phi-accrual -> AddressTerminated).
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

from ..actor.actor import Actor
from ..actor.messages import DeadLetter, Terminated
from ..actor.path import ActorPath, Address, new_uid, parse_actor_path
from ..actor.props import Props
from ..actor.provider import LocalActorRefProvider
from ..actor.ref import ActorRef, InternalActorRef
from ..dispatch import sysmsg
from ..serialization.serialization import Serialization, transport_information
from .failure_detector import FailureDetectorRegistry, PhiAccrualFailureDetector
from .transport import InProcTransport, TcpTransport, Transport, WireEnvelope


@dataclass(frozen=True)
class AddressTerminated:
    """Published on the event stream when a remote address is deemed down."""
    address: Address


@dataclass(frozen=True)
class QuarantinedEvent:
    address: Address
    uid: int


class RemoteActorRef(InternalActorRef):
    """(reference: RemoteActorRefProvider.scala:651-760)"""

    def __init__(self, path: ActorPath, provider: "RemoteActorRefProvider"):
        self.path = path
        self.provider = provider
        self._system = provider.system

    @property
    def is_local(self) -> bool:
        return False

    def tell(self, message: Any, sender: Optional[ActorRef] = None) -> None:
        self.provider.remote_send(self, message, sender, is_system=False)

    def send_system_message(self, message: sysmsg.SystemMessage) -> None:
        if isinstance(message, sysmsg.Watch):
            # node-level: heartbeat the address (RemoteWatcher.scala:34-88);
            # actor-level: forward Watch so the watchee's cell registers the
            # remote watcher and emits DeathWatchNotification on normal stop
            self.provider.remote_watcher_watch(message.watchee, message.watcher)
            self.provider.remote_send(self, message, None, is_system=True)
        elif isinstance(message, sysmsg.Unwatch):
            self.provider.remote_watcher_unwatch(message.watchee, message.watcher)
            self.provider.remote_send(self, message, None, is_system=True)
        elif isinstance(message, sysmsg.Terminate):
            # remote stop: deliver PoisonPill-ish via system channel
            self.provider.remote_send(self, _RemoteTerminate(), None, is_system=True)
        else:
            self.provider.remote_send(self, message, None, is_system=True)

    def stop(self) -> None:
        self.send_system_message(sysmsg.Terminate())


@dataclass(frozen=True)
class _RemoteTerminate:
    pass


@dataclass(frozen=True)
class _Heartbeat:
    from_address: str


@dataclass(frozen=True)
class _HeartbeatRsp:
    from_address: str


class Association:
    """Per-peer state: uid, quarantine, system-message resend buffer
    (reference: artery/Association.scala + SystemMessageDelivery.scala)."""

    def __init__(self, peer: Tuple[str, int]):
        self.peer = peer
        self.peer_uid: Optional[int] = None
        self.quarantined_uids: set[int] = set()
        self.seq = itertools.count(1)
        self.pending_acks: Dict[int, WireEnvelope] = {}   # seq -> envelope
        self.last_delivered_seq = 0                        # inbound dedup
        self.lock = threading.Lock()

    def quarantine(self, uid: int) -> None:
        with self.lock:
            self.quarantined_uids.add(uid)

    def is_quarantined(self, uid: int) -> bool:
        return uid in self.quarantined_uids


class RemoteWatcher(Actor):
    """Cross-node DeathWatch: heartbeats per watched address + phi accrual
    (reference: remote/RemoteWatcher.scala:34-88)."""

    def __init__(self, provider: "RemoteActorRefProvider",
                 heartbeat_interval: float, fd_factory):
        super().__init__()
        self.provider = provider
        self.heartbeat_interval = heartbeat_interval
        self.fd = FailureDetectorRegistry(fd_factory)
        # watchee remote ref -> set of local watcher refs
        self.watching: Dict[ActorRef, set] = {}
        self._tick_task = None

    def pre_start(self) -> None:
        self._tick_task = self.context.system.scheduler.schedule_tell_with_fixed_delay(
            self.heartbeat_interval, self.heartbeat_interval,
            self.self_ref, "tick", self.self_ref)

    def post_stop(self) -> None:
        if self._tick_task is not None:
            self._tick_task.cancel()

    def _addresses(self):
        return {str(w.path.address) for w in self.watching}

    def receive(self, message: Any):
        if message == "tick":
            for addr_s in self._addresses():
                addr = Address.parse(addr_s)
                self.provider.send_control(addr, _Heartbeat(str(self.provider.local_address)))
                if self.fd.is_monitoring(addr_s) and not self.fd.is_available(addr_s):
                    self._address_terminated(addr)
        elif isinstance(message, _HeartbeatRsp):
            self.fd.heartbeat(message.from_address)
        elif isinstance(message, tuple) and message and message[0] == "watch":
            _, watchee, watcher = message
            self.watching.setdefault(watchee, set()).add(watcher)
        elif isinstance(message, tuple) and message and message[0] == "unwatch":
            _, watchee, watcher = message
            watchers = self.watching.get(watchee)
            if watchers is not None:
                watchers.discard(watcher)
                if not watchers:
                    self.watching.pop(watchee, None)
        else:
            return NotImplemented
        return None

    def _address_terminated(self, address: Address) -> None:
        self.context.system.event_stream.publish(AddressTerminated(address))
        addr_s = str(address)
        for watchee, watchers in list(self.watching.items()):
            if str(watchee.path.address) == addr_s:
                for watcher in watchers:
                    if isinstance(watcher, InternalActorRef):
                        watcher.send_system_message(sysmsg.DeathWatchNotification(
                            watchee, existence_confirmed=False, address_terminated=True))
                self.watching.pop(watchee, None)
        self.fd.remove(addr_s)


class RemoteActorRefProvider(LocalActorRefProvider):
    def __init__(self, system_name: str, settings, event_stream):
        super().__init__(system_name, settings, event_stream)
        self.uid = new_uid() + int(time.time() * 1000) % (1 << 20)
        self.transport: Optional[Transport] = None
        self.local_address: Optional[Address] = None
        # pickle on the wire is opt-in only (JavaSerializer-off parity;
        # default = fixed-schema codecs, serialization/codec.py)
        self.serialization = Serialization(
            allow_pickle=settings.config.get_bool(
                "akka.remote.allow-pickle", False))
        self._associations: Dict[Tuple[str, int], Association] = {}
        self._assoc_lock = threading.Lock()
        self._remote_watcher = None
        self._resend_task = None
        # per-message wire instrumentation (RemoteInstrument.scala:32):
        # config entries "module:Class" plus programmatic
        # provider.remote_instruments.add(...)
        from .instrument import RemoteInstruments
        self.remote_instruments = RemoteInstruments.from_config(
            settings.config.get_list("akka.remote.instruments", []))

    # -- bootstrap -----------------------------------------------------------
    def init(self, system) -> None:
        super().init(system)

    def post_init(self, system) -> None:
        cfg = self.settings.config
        host = cfg.get_string("akka.remote.canonical.hostname", "127.0.0.1")
        port = cfg.get_int("akka.remote.canonical.port", 0)
        self.large_message_threshold = cfg.get_int(
            "akka.remote.large-message-threshold", 32 * 1024)
        kind = cfg.get_string("akka.remote.transport", "tcp")
        if kind == "inproc":
            self.transport = InProcTransport()
        elif kind == "tls-tcp":
            # TLS on the wire (SSLEngineProvider.scala:66 seam): PEM paths
            # from akka.remote.tls.*, mutual auth on by default
            from .transport import TlsSettings, TlsTcpTransport
            self.transport = TlsTcpTransport(TlsSettings.from_config(cfg))
        else:
            self.transport = TcpTransport()
        bound_host, bound_port = self.transport.listen(host, port, self._inbound)
        self.local_address = Address("akka", self.system_name, bound_host, bound_port)
        self.transport.local_address = f"{bound_host}:{bound_port}"
        self._flight = getattr(system, "flight_recorder", None)
        if self._flight is not None:
            self._flight.transport_started(str(self.local_address))
        # rebase the guardian hierarchy's notion of our address for remote paths
        self.root_path = ActorPath(self.local_address)
        fd_cfg = cfg.get_config("akka.remote.watch-failure-detector")
        self._remote_watcher = system.system_actor_of(
            Props.create(
                RemoteWatcher, self,
                fd_cfg.get_duration("heartbeat-interval", "1s"),
                lambda: PhiAccrualFailureDetector(
                    threshold=fd_cfg.get_float("threshold", 10.0),
                    max_sample_size=fd_cfg.get_int("max-sample-size", 200),
                    min_std_deviation=fd_cfg.get_duration("min-std-deviation", "100ms"),
                    acceptable_heartbeat_pause=fd_cfg.get_duration(
                        "acceptable-heartbeat-pause", "10s"),
                    first_heartbeat_estimate=fd_cfg.get_duration(
                        "expected-first-heartbeat-estimate", "1s"))),
            "remote-watcher")
        resend_interval = cfg.get_duration("akka.remote.system-message-resend-interval", "1s")
        self._resend_task = system.scheduler.schedule_with_fixed_delay(
            resend_interval, resend_interval, self._resend_pending)
        # /remote daemon: instantiates DaemonMsgCreate recipes from peers
        # (reference: RemoteSystemDaemon under the root guardian)
        from .deploy import RemoteSystemDaemon
        self.remote_daemon = self.root_guardian.cell.actor_of(
            Props.create(RemoteSystemDaemon, self).with_dispatcher(
                system.dispatchers.INTERNAL_DISPATCHER_ID),
            "remote")
        system.register_on_termination(self.shutdown_transport)

    def shutdown_transport(self) -> None:
        if self._resend_task is not None:
            self._resend_task.cancel()
        if self.transport is not None:
            self.transport.shutdown()

    # -- address helpers -----------------------------------------------------
    @property
    def default_address(self) -> Address:
        return self.local_address or self.root_path.address

    def _association(self, addr: Address) -> Association:
        key = (addr.host, addr.port)
        with self._assoc_lock:
            a = self._associations.get(key)
            if a is None:
                a = Association(key)
                self._associations[key] = a
                fr = getattr(self, "_flight", None)
                if fr is not None:
                    fr.association_opened(f"{addr.host}:{addr.port}")
            return a

    def quarantine(self, address: Address, uid: int) -> None:
        """(reference: Association quarantine :290-314)"""
        self._association(address).quarantine(uid)
        self.event_stream.publish(QuarantinedEvent(address, uid))
        fr = getattr(self, "_flight", None)
        if fr is not None:
            fr.association_quarantined(str(address), f"uid={uid}")

    # -- outbound ------------------------------------------------------------
    def remote_send(self, ref: RemoteActorRef, message: Any,
                    sender: Optional[ActorRef], is_system: bool) -> None:
        addr = ref.path.address
        assoc = self._association(addr)
        if assoc.peer_uid is not None and assoc.is_quarantined(assoc.peer_uid):
            self.dead_letters.tell(DeadLetter(message, sender, ref), sender)
            return
        with transport_information(self):
            sid, manifest, payload = self.serialization.serialize(message)
        sender_path = None
        if sender is not None:
            sp = sender.path
            if sp.address.has_local_scope and self.local_address is not None:
                sp = sp.with_address(self.local_address)
            sender_path = sp.to_serialization_format()
        # lane selection (ArteryTransport.scala:383-428): system messages
        # ride the control lane; oversized payloads ride a DEDICATED large
        # lane (own connection) so one big transfer cannot head-of-line
        # block ordinary traffic. Artery picks by destination config; a
        # size threshold is the natural form when payloads are on hand.
        # Like Artery, ordering holds WITHIN a lane, not across lanes.
        if is_system:
            lane = "control"
        elif len(payload) >= self.large_message_threshold:
            lane = "large"
        else:
            lane = "ordinary"
        env = WireEnvelope(
            recipient=ref.path.to_serialization_format(),
            sender=sender_path,
            serializer_id=sid, manifest=manifest, payload=payload,
            is_system=is_system,
            from_address=str(self.local_address), from_uid=self.uid,
            lane=lane)
        if self.remote_instruments:
            # serialize-time hook: instruments stamp the reserved header
            # space (RemoteInstrument.remoteWriteMetadata)
            env.metadata = self.remote_instruments.write_metadata(
                ref, message, sender)
        if is_system:
            with assoc.lock:
                env.seq = next(assoc.seq)
                assoc.pending_acks[env.seq] = env
        ok = self.transport.send(addr.host, addr.port, env)
        if ok and self.remote_instruments:
            self.remote_instruments.message_sent(
                ref, message, sender, len(env.payload or b""))
        fr = getattr(self, "_flight", None)
        if fr is not None:
            if ok:
                fr.remote_message_sent(f"{addr.host}:{addr.port}",
                                       len(env.payload or b""))
            else:
                fr.event("remote_send_failed",
                         peer=f"{addr.host}:{addr.port}")
        if not ok and not is_system:
            self.dead_letters.tell(DeadLetter(message, sender, ref), sender)

    def send_control(self, addr: Address, message: Any) -> None:
        with transport_information(self):
            sid, manifest, payload = self.serialization.serialize(message)
        env = WireEnvelope(
            recipient=f"{addr}/system/remote-watcher",
            sender=None, serializer_id=sid, manifest=manifest, payload=payload,
            from_address=str(self.local_address), from_uid=self.uid, lane="control")
        self.transport.send(addr.host, addr.port, env)

    def _resend_pending(self) -> None:
        with self._assoc_lock:
            assocs = list(self._associations.items())
        for (host, port), assoc in assocs:
            with assoc.lock:
                pending = list(assoc.pending_acks.values())
            for env in pending:
                self.transport.send(host, port, env)

    # -- inbound -------------------------------------------------------------
    def _inbound(self, env: WireEnvelope) -> None:
        try:
            fr = getattr(self, "_flight", None)
            if fr is not None:
                fr.remote_message_received(env.from_address or "?",
                                           len(env.payload or b""))
            self._handle_inbound(env)
        except Exception as e:  # noqa: BLE001 — transport thread must survive
            self.event_stream.publish(DeadLetter(f"inbound error: {e!r}", None, None))

    def _handle_inbound(self, env: WireEnvelope) -> None:
        from_addr = Address.parse(env.from_address) if env.from_address else None
        ack_after_delivery = None
        if from_addr is not None:
            assoc = self._association(from_addr)
            if assoc.is_quarantined(env.from_uid):
                return
            if assoc.peer_uid is None:
                assoc.peer_uid = env.from_uid
            elif assoc.peer_uid != env.from_uid:
                # restarted incarnation: quarantine the old uid (reference:
                # quarantine of stale UIDs, artery/Handshake + InboundQuarantineCheck)
                assoc.quarantine(assoc.peer_uid)
                assoc.peer_uid = env.from_uid
                assoc.last_delivered_seq = 0
            if env.is_system and env.seq is not None:
                with assoc.lock:
                    if env.seq <= assoc.last_delivered_seq:
                        self._send_ack(from_addr, assoc)
                        return  # duplicate
                # ack only AFTER successful deserialize+delivery, so a failed
                # delivery is resent rather than silently acked away
                ack_after_delivery = (from_addr, assoc, env.seq)
            if env.ack is not None:
                with assoc.lock:
                    for s in [s for s in assoc.pending_acks if s <= env.ack]:
                        assoc.pending_acks.pop(s, None)
                if env.serializer_id == -1:
                    return  # pure ack

        with transport_information(self):
            message = self.serialization.deserialize(env.serializer_id, env.manifest,
                                                     env.payload)
        # control-plane messages
        if isinstance(message, _Heartbeat):
            addr = Address.parse(message.from_address)
            self.send_control(addr, _HeartbeatRsp(str(self.local_address)))
            return
        if isinstance(message, _HeartbeatRsp):
            if self._remote_watcher is not None:
                self._remote_watcher.tell(message)
            return

        recipient = self.resolve_actor_ref(env.recipient)
        sender = (self.resolve_actor_ref(env.sender) if env.sender
                  else self.dead_letters)
        if self.remote_instruments:
            # deliver-time hook: same-identifier instruments read back the
            # metadata stamped on the sending side
            self.remote_instruments.read_metadata(
                recipient, message, sender, env.metadata)
            self.remote_instruments.message_received(
                recipient, message, sender, len(env.payload or b""))
        if recipient is self.dead_letters:
            # a message (user OR system: Watch must not be lost either) that
            # raced a remote deployment: hand it to the daemon, which buffers
            # until DaemonMsgCreate lands (remote/deploy.py)
            try:
                elements = list(parse_actor_path(env.recipient).elements)
            except ValueError:
                elements = []
            if len(elements) == 2 and elements[0] == "remote":
                from .deploy import _DeliverToChild
                self.remote_daemon.tell(
                    _DeliverToChild(elements[1], message, sender,
                                    system=env.is_system))
                if ack_after_delivery is not None:
                    addr, assoc, seq = ack_after_delivery
                    with assoc.lock:
                        assoc.last_delivered_seq = max(assoc.last_delivered_seq, seq)
                    self._send_ack(addr, assoc)
                return
        if isinstance(message, _RemoteTerminate):
            if isinstance(recipient, InternalActorRef):
                recipient.stop()
        elif env.is_system and isinstance(message, sysmsg.SystemMessage):
            if isinstance(recipient, InternalActorRef):
                recipient.send_system_message(message)
        else:
            recipient.tell(message, sender)
        if ack_after_delivery is not None:
            addr, assoc, seq = ack_after_delivery
            with assoc.lock:
                assoc.last_delivered_seq = max(assoc.last_delivered_seq, seq)
            self._send_ack(addr, assoc)

    def _send_ack(self, addr: Address, assoc: Association) -> None:
        env = WireEnvelope(recipient="", sender=None, serializer_id=-1,
                           manifest="", payload=b"", is_system=False,
                           ack=assoc.last_delivered_seq,
                           from_address=str(self.local_address), from_uid=self.uid,
                           lane="control")
        self.transport.send(addr.host, addr.port, env)

    # -- remote deployment (reference: RemoteActorRefProvider.actorOf :152
    # — a RemoteScope deploy creates the actor on the remote node) -----------
    def actor_of(self, system, props: Props, supervisor: InternalActorRef,
                 path: ActorPath) -> InternalActorRef:
        from ..actor.deploy import RemoteScope
        eff_props, deploy = self.effective_props(props, path)
        scope = getattr(deploy, "scope", None)
        if (isinstance(scope, RemoteScope) and self.local_address is not None
                and Address.parse(scope.address) != self.local_address):
            from .deploy import remote_deploy
            return remote_deploy(self, eff_props, path, deploy)
        return super().actor_of(system, eff_props, supervisor, path,
                                _resolved=True)

    # -- resolution ----------------------------------------------------------
    def resolve_actor_ref(self, path: Any) -> ActorRef:
        if isinstance(path, str):
            try:
                path = parse_actor_path(path)
            except ValueError:
                return self.dead_letters
        if self.local_address is not None and path.address == self.local_address:
            return self.resolve_local(path)
        if path.address == ActorPath(Address("akka", self.system_name)).address:
            return self.resolve_local(path)
        if path.address.has_global_scope:
            return RemoteActorRef(path, self)
        return self.dead_letters

    # -- remote deathwatch ----------------------------------------------------
    def remote_watcher_watch(self, watchee, watcher) -> None:
        if self._remote_watcher is not None:
            self._remote_watcher.tell(("watch", watchee, watcher))

    def remote_watcher_unwatch(self, watchee, watcher) -> None:
        if self._remote_watcher is not None:
            self._remote_watcher.tell(("unwatch", watchee, watcher))
