#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (akka_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --remote-phase N   # remote_paths alone, N times
    python3 chip_smoke.py --ddata-phase N    # ddata_paths alone, N times
    python3 chip_smoke.py --sharding-phase N # sharding_paths alone, N times
    python3 chip_smoke.py --stream-phase N   # stream_paths alone, N times
    python3 chip_smoke.py --stream-io-phase N  # stream_io_paths alone

1. Prints the card's name and power limit (nvidia-smi) and builds the
   ring-mailbox kernels from akka_tpu_torch/csrc (nvcc, sm_90a).
2. Holds each kernel against its plain PyTorch version on the card, at a
   small ragged shape and at the main path's shape (m = 2^20 + 8 rows,
   n = 2^20 actors, P = 4, S = 2) under three traffic patterns (random,
   ring, 1000-collector fan-in; akka_tpu_torch/tools/bench_mailbox.py),
   in float32, int32 and bf16 payloads (int32 and bf16 also at small
   shapes with P = 4 and 5, and K2 with its payload, ring payload, and
   for bf16 its sums or accumulator, off the alignment of its vector
   branch): integer outputs (int32 sums included)
   bit-equal, float32 sums within rtol 1e-4 / atol 1e-3 (float atomics
   add in a run-dependent order), bf16 sums within one bf16 ulp plus the
   float32 reordering allowance 2 k 2^-24 sum|x| (both sides add in
   float32, then round once). For each it times the C entry on the
   card's clock (CUDA events around 200 launches on outputs allocated
   once, zeroing included: `ms`), the Python wrapper (`wrapper_ms`), the
   plain version and, for K1, its yardstick: one `index_add_`
   (bench_mailbox.library_reduce; float32-widened for bf16 and rounded
   once, held to the plain version; the bf16 `index_add_` is timed and
   checked beside it), and computes the memory-bytes bound at 3.35 TB/s
   at the payload's element size. Each K2 row also prints its device
   time by kernel and memset under torch.profiler (`by_kernel`).
Every path steps through replays of the step's CUDA graph
(akka_tpu_torch/batched/graphs.py): the systems capture it in warmup(),
before a path's launch counts are zeroed (the eager warm-up steps before
a first capture launch the kernels too) and before a gateway's front end
starts; the hand-off window's graph is captured at the first rebalance.
A capture that fails raises; nothing falls back to eager. Each step cell
and region_serve keep an eager twin in the same call, built and driven
alike, that steps through the private `_step_impl` loop: integer carries
must be bit-equal to the graph system's, floats within rtol 1e-4 /
atol 1e-3, and the two are timed as interleaved pairs (graph, eager,
graph, ...; host-clock times spread between calls). Launch counts are
zeroed just before each stretch of a path on the graph system and read
just after (the twin runs between stretches), and K1/K2 must launch
exactly once per step by replay count; on ring_reduce and
cross_shard_d8 a torch.profiler trace must show `ring_sweep` once per
replayed step (a trace that lost records is taken again; see
host_launches). For each phase it prints ms/step (or asks/s, requests/s
and reply p50/p99), the host's CUDA launch calls per step (profiler),
the captures and their ms, and torch.cuda.memory_reserved(); each
phase's systems, and their graph pools, are freed before the next.

3. Drives the main path through BatchedSystem on the card at 1M actors:
   the ring in reduce mode (and tells followed by step()), the
   1M -> 1k fan-in, the ring with 2-slot bounded mailboxes (and a twin
   on the ranked kernels, which must agree bit for bit), the same ring in
   reduce and slots mode with int32 and bf16 payloads (ring_reduce_int32,
   ring_slots_int32, ring_reduce_bf16, ring_slots_bf16; each with a
   ranked twin), and the compiled-routing ring and fan-in (ring_static,
   kind shift; fan_in_static, kind mod: no ring kernel launch, each held
   to its dynamic counterpart). Each result is held to its closed form.
   The reference's supervision bench runs as graphs at 1M actors
   (ring_plain, ring_supervised with LaneSupervisor(), ring_chaos with
   crashes injected at 1e-3 per lane and step by
   akka_tpu_torch.testkit.chaos.inject; 5 interleaved windows of 20
   steps): the quiet counters must stay zero, and the chaos run's
   failures, all restarted, must equal the count chaos_hit_np schedules
   for the lanes that held a token.
4. Drives the sharded system (ShardedBatchedSystem) at bench config 5,
   256 logical shards x 4096 entities = 2^20 actors, seeded with one token
   each: on one shard (sharded_ring_d1), on 8 shards of the card where
   every message crosses a shard (cross_shard_d8), and on 8 shards with
   2-slot bounded mailboxes (sharded_slots_d8, bit-equal to its twin on
   the ranked kernels). Every actor must have received one token per
   step and nothing may be dropped.
5. Serves asks through the region (DeviceShardRegion of the gateway's
   counter entity, 256 shards x 4096 entities on one shard of the axis,
   two spare blocks), the graph region and its eager twin in turn: one
   warm wave, 32 timed ask_many waves of 256 adds (integer-valued
   floats, so every sum is exact; about an eighth of each wave repeats
   an entity of the same wave), one profiled wave, a solo ask, a
   rebalance of one shard and a wave over its entities. Every reply must
   equal a host oracle's running total and the twin's reply, the totals
   must be conserved, and no ask may be left in flight (region_serve).
   The same trace on regions with 2-slot bounded mailboxes
   (region_serve_slots) must give bit-equal replies and launch K2, and
   on regions with 2 slots and the default spill region
   (region_serve_spill: the ranked kernels at full width, whose summed
   reply-row ids pass 2^24) bit-equal replies and no ring launch.
6. Serves the gateway on the card (akka_tpu_torch.tools.gateway_load):
   a full-width counter region (256 shards x 4096 entities, one shard of
   the axis, two spare blocks) behind RegionBackend(continuous=True,
   pipeline_depth=4) and GatewayServer(transport="evloop",
   aggregate=True) on 127.0.0.1, admission shedding only on ask-pool
   occupancy > 0.9. 16 client threads, each with its own GatewayClient
   and 64 entities of its own, send 512 integer-valued adds each as
   pipelined binary windows of 8 (depth 4); sheds are retried and
   counted (gateway_serve). Every ok reply must equal its client's
   running total, sum_all the acked sum (plus the warm-up), no reply may
   be an error, and no ask may be in flight after quiesce. A short
   profiled load follows. The same trace with continuous=False
   (gateway_serve_serialized) must give the same replies and totals, and
   the first 128 adds of each client on a region with 2-slot bounded
   mailboxes (gateway_serve_slots) the replies gateway_serve gave them.
   gateway_serve_durable runs gateway_serve's trace on a region with the
   tell WAL and the entity journal attached (an fsync per WAL record and
   per entity-journal wave): the same replies, the journal's fold equal
   to the acked totals, and its fsyncs per 256 requests.
7. Durability (akka_tpu_torch.persistence, DeviceShardRegion's
   checkpoint/restore). region_restore: the region_serve region with
   both journals and an uninterrupted twin take 16 ask waves of 256
   adds, a rebalance (which drains the hand-off window and checkpoints
   itself), the timed checkpoint(), 16 more waves and 64 tells to new
   entities staged but not stepped; the journaled region is dropped
   without a goodbye and a fresh one, warmed up, restores from the
   directory. Every entity's total must equal the twin's and the host
   oracle's, the entity journal's fold the acked totals, the replay must
   launch K1 once per replayed step (counts zeroed just before
   restore()), and the same-shape restore must keep the warmed graph. It
   prints the snapshot's bytes, checkpoint_ms, and restore_ms split into
   load, H2D and replay. region_restore_slots: the same with 2-slot
   bounded mailboxes, on K2. gateway_kill9: a full-width durable,
   deduplicating `serving_gateway serve` child on the card and two
   `load` children; the server is SIGKILLed mid-load and restarted with
   --restore on the same port and directory; acked_sum <= final_total <=
   sent_sum must hold, the `durable` admin op must report the respawned
   entities, and the restored server's replay must have launched K1 once
   per step (it prints its counts). It prints the wall time from SIGKILL
   to READY.
8. The observed step (observed_paths). ring_metrics: the reference's
   metrics-overhead bench (bench.py bench_metrics_overhead) as graphs at
   2^20 actors, the dynamic ring with the metric slab off and on, quiet
   (no token) and active (seeded), timed in OBS_WINDOWS interleaved
   windows of STEPS steps; the quiet-on epoch must stay 0, the active-on
   drain must hold mailbox_occupancy (one message per actor and step,
   bucket 1) and sojourn_steps, and equal read_metrics() and an eager
   twin's lanes bit for bit; it prints quiet_overhead_pct and
   active_overhead_pct (numbers, not gates). region_observed:
   region_serve's region with the metric slab on, a Tracer sampling
   every trace (attach_tracer), a MetricsRegistry on the entity journal
   and on the ask engine (an AskBatcher whose waves run on the caller's
   thread) and an InMemoryFlightRecorder on the system, serving
   region_serve's waves, traced and untraced in turn (asks/s of each);
   every reply must equal the oracle, the spans and recorder events must
   export to a Perfetto document with no validate_trace error, every
   wave span's step stamps lie on the region's step axis, the
   device_step events account for every step, and one drain_metrics ->
   ingest_device_slab puts the device lanes into expose(). Then the
   registry's HTTP endpoint is scraped once and its JSONL emitter writes
   into a temporary directory; close() must join both threads.
   profiler_trace: start_trace, run(STEPS) on the ring, stop_trace; the
   Chrome trace must hold the run's akka.device.run[...] range and K1's
   ring_sweep kernels inside it.
9. Device actors through the public API (actor_paths).
   actor_ring: an ActorSystem whose akka.actor.tpu-dispatcher holds
   2^20 rows (P = 4, reduce, 256 promise rows, a host inbox of
   2^20 - 256 rows); system.actor_of(device_props(ring_n, n=2^20 - 256))
   with ring_n a ring that wraps at its block
   (make_block_ring_behavior), one DeviceBlockRef.tell seeding every
   row, then handle.step(20) three times on CUDA events (ms/step printed
   beside ring_reduce's); every actor must hold one token per step and
   K1 must launch once a step (the counts and the step counter read
   under the handle's step lock, so a pump step falls wholly inside or
   outside the window). actor_ask: a second tpu-batched dispatcher of
   the same system (2^20 rows, 4 bounded slots, depth 4) with 4096
   counter actors; the reference's bridge-latency pair (bench.py
   bench_bridge_latency: the sync round against the depth-4 round, 200
   rounds each, and steps/s), then 32 rounds of 256 concurrent tell +
   ref.ask pairs through the pump thread, every reply held to a host
   oracle, ask p50/p99 µs, pipeline_stats() and ask_pool_stats(); K2
   must launch once a step. actor_lifecycle: a system whose default
   dispatcher is tpu-batched: a host Echo actor beside device actors,
   asks, deathwatch (Terminated to a TestProbe, a late tell a
   DeadLetter), a poisoned row restarted to its spawn-time init
   (DeviceActorFailed), a new behavior type spawned with 7 asks in
   flight (a rebuild: every reply and the state held, the captures
   printed), and a bf16 handle at 256 rows asked once (bf16 K1).
10. Holds both kernels against their plain versions once more at the
   shapes these paths gave them: the 8-shard flat inboxes (sharded_d8),
   the region's inbox as a wave's tells land (region), the gateway
   region's (gateway), the actor paths' inboxes (actor_ring, actor_ask
   at S = 4, actor_lifecycle_bf16) and those of the later phases
   (typed_persistence, remote_ask_*, cluster_router).
11. BASELINE configs 4 and 1 (baseline_paths). router and router_api:
   build_router / build_router_api at 2^20 producers and 100k routees
   (1,148,576 rows), step cells against their eager twins; every routee
   hit closes to (steps - 1) * 2^20 (deliveries lag a step,
   bench.py:145-165), round robin spreads within a hit a step, the two
   builders' hits are bit-equal, K1 launches once a step; K1 is held to
   its plain version on the router's inbox (~10.5 messages a recipient,
   pattern `router`). ping_pong: bench.py bench_latency (2000 rounds of
   tell -> step() -> sync, p50/p99 of the round and its tell, dispatch
   and block parts; then step() + sync against run_pipelined(depth=2) in
   steps/s) for the native stager and the Python list, in 3 interleaved
   pairs; hits[0] + hits[1] equal a host replay of the exchange; two
   actors deliver by scatter, so no ring kernel launches.
12. device_pipeline (pipeline_paths): a map -> filter -> map -> scan
   chain over 64 stacked chunks of 2^20 float32 (256 MiB) as CUDA-graph
   replays against the same chain run eagerly, 3 interleaved pairs (ms
   per chunk); outputs, masks and carry bit-equal, compact() equal to a
   numpy oracle of the chain.
13. The native stager against the Python list (staging_paths), in 3
   interleaved pairs: actor_ask's rounds on two dispatchers of one
   system (handles with native_staging true and false; 8 rounds of 256
   tell + ask a leg) and the ring's tell_step at 2^20 actors (200 rounds of three
   tells, step() and a sync a leg); each prints tell p50/p99 and asks/s
   (steps/s), holds its oracle, must have staged through its buffer (it
   held tells before a flush) and dropped nothing; K2 (K1) once a step.
14. Failover and the elastic mesh over shard slots of the card
   (failover_paths). sentinel_failover: a MeshSentinel of 1,048,560 rows
   (256 promise rows, 4096 echo rows, a ring over the rest seeded with a
   token on every row: K1 delivers ~1M messages a step) on 4 slots,
   snapshots every 8 steps and the WAL, under a DeviceLossInjector (seed
   7, loss rate 0.01: slot 3 lost at step 42) fails over to 3 slots on
   its own; at step 56 it must equal an uninterrupted twin (integers
   bit-equal, sums within rtol/atol); it prints MTTR, the rebuild's load,
   restore, replay and capture ms, and bench.py's manual-restore baseline
   with mttr_over_restore. sentinel_reshard: the same sentinel walks
   scale_to 3 -> 2 -> 4 -> 8 -> 4 slots with 256 asks in flight across
   each transition (every reply twice its value), the ring's tokens
   conserved, each pause_s printed, and the memory allocated at the last
   4-slot mesh no more than at the first (old graphs and pools gone).
   autoscale: a 2-slot sentinel whose 1000 collectors' bounded 2-slot
   mailboxes (K2) overflow every step; an attached MeshAutoscaler widens
   it to 4 slots on mailbox_overflow and prints its decision.
   region_failover(_slots): region_serve's region on 2 slots with both
   journals: 16 ask waves, a checkpoint, 8 waves, failover to 1 slot, 16
   waves; every reply and total equals the host oracle (K1; K2 with 2
   bounded slots). Each leg's launches are counted, and each kernel is
   held to its plain version on the leg's fullest inbox.
15. Ranks over torch.distributed (rank_paths, ROADMAP A10.2).
   initialize_distributed("127.0.0.1:<free port>", 1, 0) starts an NCCL
   group of world size 1 (the machine has one card). rank_nccl_ring:
   build_cross_shard(256, 4096) on a ranked mesh of 8 slots over it,
   stepping through CUDA graphs with the exchange's all_to_all_single
   captured inside, against cross_shard_d8's one-card twin (a run of 20
   steps, 3 interleaved timed pairs, 5 profiled steps of each: the
   ranked step's device time beyond its twin's, name by name, and
   NCCL's kernels); the closed form, every carry field (integers
   bit-equal, floats within rtol/atol) and K1 once a step.
   rank_nccl_slots: the same for build_cross_shard_slots (K2).
   rank_region_nccl: region_serve's region on 2 slots of the group with
   both journals (a WAL fsync per tell): 16 ask waves of 256 adds, a
   checkpoint, a restore into a fresh region, 8 waves; every reply and
   total equals the host oracle. rank_banks_nccl: converge_over_mesh of
   a 2^20-key uint32 max bank and an "or" set held to the one-card join.
   Then two gloo ranks as threads of this script, every rank's tensors on
   the card, eager steps (a gloo group cannot be captured):
   rank_gloo_ring (the same ring, 4 slots a rank, 10 steps, every rank's
   global carry held to the one-card twin's; gloo takes the CUDA tensors
   as they are, and the port stages nothing through host memory),
   rank_region_gloo and rank_banks_gloo (1 slot a rank). The NCCL group
   is destroyed in a finally; then rank_actor_system: an ActorSystem
   with akka.jax-distributed.enabled starts its own NCCL group (an
   all_reduce and a host ask go through) and terminate() destroys it.
   K1 and K2 are counted on every leg and held to their plain versions
   on each leg's fullest rank-local inbox.
16. Event-sourced typed actors over device counters
   (typed_persistence_paths, ROADMAP A12.1). A typed ActorSystem on the
   file journal and the local snapshot store (absolute dirs under one
   temporary directory) whose guardian spawns 4096 slots_counter device
   actors through TypedActorContext.spawn(props=device_props(...)) on a
   tpu-batched dispatcher of actor_ask's shape (2^20 rows, 4 bounded
   slots: K2, depth 4, 256 promise rows) and 64 EventSourcedBehavior
   ledgers (a snapshot every 64 events), each registered with the
   Receptionist; ledger 0 runs under a BackoffSupervisor. The script
   finds the ledgers through Find and sends 16 rounds of 256 commands
   (seed 5; the counters of a round distinct, the ledgers uniform): a
   ledger tells the add to its counter, asks it (ctx.ask, piped to
   itself), persists (counter, value, total) as plain numbers and
   replies. Every reply, every counter's device state and every ledger's
   state equal a host oracle; K2 launches once a step. A fresh system on
   the same dirs: every ledger recovers from its snapshot plus the tail
   to the oracle, PersistenceQuery's current events of two ledgers equal
   what they persisted, and a poison command crashes ledger 0, whose
   supervisor restarts it after its minimum backoff; it recovers and
   answers the next command (GetRestartCount 1). It prints commands/s,
   command and journal-write p50/p99 (host clock), the ledgers' recovery
   ms, and K2 is held to its plain version on the fullest carried inbox
   of all 16 rounds (its valid rows counted after every step, a sync a
   step inside the timed rounds). The phase must finish within 60 s.
17. Device actors across nodes (remote_paths). remote_ask_inproc,
   remote_ask_tcp, remote_ask_tls: two provider = remote systems in
   this process over the in-proc transport, TCP and TLS (the committed
   test PKI, tests/data/torch_pki) on 127.0.0.1 port 0; node B holds
   actor_ask's dispatcher shape (2^20 rows, 4 bounded slots: K2, depth
   4, 256 promise rows), 4096 slots_counter device actors and a host
   Front at /user/front (a device actor replies to asks only: the front
   tells the add, asks the counter and pipes the reply); node A resolves
   B's front as a RemoteActorRef and sends 16 rounds of 256 remote asks
   (seed 5, a round's counters distinct), every reply and every
   counter's state held to a host oracle, a live-row count after every
   step (K2's input: the fullest carried inbox). Then a remote tell to a
   DeviceActorRef's canonical path (B resolves that path to the very
   ref), read back; on TCP a 2^16-float32 card tensor told over the
   large-message lane, equal on arrival, the lane's own connection
   asserted; a remote watch of a device ref that B stops (Terminated on
   A). Each leg prints asks/s, ask p50/p99, steps, replays and the busy
   share (CUDA events around each replay); K2 once a step.
   cluster_router: three provider = cluster systems over TCP loopback
   (gossip 0.05 s, heartbeat 0.1 s, pause 2 s, keep-majority after
   1 s), each a reduce-mode dispatcher (2^20 rows: K1) with 1024
   counter_behavior counters and a Front; node 0's ClusterRouterGroup
   of RoundRobinGroup(["/user/front"]) reaches 3 routees; 8 rounds of
   256 asks through it, each reply (node, counter, total) held to that
   node's oracle; node 0 watches node 2's front; node 2 crashes
   (provider.shutdown_transport(), then terminate()); the survivors
   remove it, the router falls to 2 routees, node 0 gets Terminated
   (address terminated); 8 more rounds. It prints the time to form,
   crash to removed, asks/s and p50/p99 before and after, and K1
   launches by node (once a step on every handle). Every system is
   terminated and awaited before the next leg; the phase must finish
   within 60 s.
18. Replicated state and cluster tools (ddata_paths, ROADMAP A12.3).
   Three provider = cluster systems over TCP loopback (cluster_router's
   membership settings; the split-brain resolver's lease-majority over
   the in-proc lease), each running ddata's replicator at the fast
   settings (gossip 0.1 s, delta propagation and notify 0.05 s). Node 0
   holds gateway_region(0)'s full-width counter region (K1) with the tell
   WAL and the entity journal, its remember store the replicated
   DDataRememberEntitiesStore, its coordination lease an InProcLease of
   the LeaseProvider, and a ReadReplicaCache that publishes each wave's
   totals through the replicator. make_trace(seed=7) of 32 waves of 256
   adds, a checkpoint after wave 16, every reply held to a host oracle;
   K1 once per region step; a wave's new ids go to the store in one
   batch. remember_ddata: every shard's ORSet read locally on nodes 1
   and 2 equals node 0's ids, each with its row; node 1 restores a fresh
   region of the same spec, with its own store, from a copy of node 0's
   directory without the entity journal and entities.log: every
   remembered id at its row, the ids equal the ORSets' union, every
   total equals the oracle, K1 once per replayed step. replica_ddata:
   the caches of nodes 1 and 2, fed by their replicators alone, equal
   node 0's view (publish-to-visible p50/p99 on node 2, host clock).
   receptionist: a ReplicaReader per node, registered with the cluster
   Receptionist; node 0 finds the three through the replicated registry
   and each answers 64 reads with the oracle's totals. lease: a rival
   holds the region's lease and rebalance raises; released, the region
   takes it, rebalances, and 4 more waves equal the oracle. Node 2
   crashes; the lease-majority resolver of nodes 0 and 1 takes the SBR
   lease and removes it (the lease's holder checked; crash to removal
   printed). metrics: ClusterMetricsExtension with the device
   probe on node 0 samples used memory > 0 and the card's total memory
   as the limit. K1 is held to its plain version on the fullest inbox of
   node 0's waves. Every system is terminated and awaited; the phase
   must finish within 60 s.
19. Host sharding in front of the device region (sharding_paths,
   ROADMAP A12.4). Two provider = cluster systems over TCP loopback
   (FAST_MEMBERSHIP, the replicator at the fast settings); sh0 joins
   first, so it is the oldest and holds the shard coordinator.
   ClusterShardingTyped.init_device on sh0 builds gateway_region(0)'s
   full-width counter region (K1) behind an AskBatcher and a host front
   registered with the cluster Receptionist. Typed Account entities on
   both nodes (64 host shards, remember-entities in the ddata store,
   the reference's fast 0.1 s retry and 0.3 s rebalance) each own one
   device row; 2048 ids are started and balanced over the two regions
   first. 16 rounds of 256 concurrent EntityRef.asks (seed 11, a round's
   ids distinct), half through each node's entity_ref_for: the Account
   asks the front (ctx.ask, the reply piped back) and answers with its
   row's total, held to a host oracle. After round 8 sh1 leaves and
   terminates; one StartEntity per shard it hosted brings those shards
   home to sh0, whose Shards restart the rest of their remembered ids
   (every remembered id of sh1 must run on sh0); rounds 9-16 run from
   sh0 alone. Every touched device row equals the oracle; K1 launches
   once a region step and is held to its plain version on the fullest
   inbox. It prints asks/s and ask p50/p99 ms per leg, the hand-off
   seconds, the remembered restarts and the card's busy ms; the phase
   must finish within 60 s. `--sharding-phase N` runs it alone.
20. The stream DSL in front of the device tier (stream_paths, ROADMAP
   A12.5, the core), one ActorSystem hosting the streams' interpreter
   actors. stream_region: gateway_region(0)'s full-width counter region
   (K1) behind RegionBackend(continuous=True, pipeline_depth=4);
   Source.from_iterable of 34 waves of 256 adds -> map_async(4, a wave
   staged through ask_many_async, a Future completed by its on_done) ->
   Sink.fold: the replies in element order, each the oracle's running
   total; a second run of 32 waves through KillSwitches.single(), shut
   down once 8 waves are answered: every wave that passed the switch is
   answered and the region's totals hold exactly those. stream_ask:
   actor_ask's 4096 counters (2^20 rows, 4 bounded slots: K2) asked
   from a stream, 8192 elements through map_async(256, tell + ask) with
   a row's asks never in flight together, then Flow().ask(8, ref) of
   1024 adds on one ref of a dispatcher with 8 slots and 8 emissions a
   row (ask_log: each reply the running total after its add); every
   reply equals the oracle, K2 once a step. stream_pipeline:
   device_pipeline's chain over its 64 chunks through
   Source.from_iterable(chunks).via(pipe.as_flow()) into Sink.seq, each
   (out, mask) and the final carry bit-equal to run(); ms per chunk of
   both in 3 interleaved pairs. It prints waves/s and adds/s, asks/s
   with p50/p99, and ms per chunk; K1 and K2 are held to their plain
   versions on the fullest inboxes (K2 at both dispatchers' shapes,
   S = 4 and S = 8); the phase must finish within 60 s.
   `--stream-phase N` runs it alone.
21. io/ and the rest of stream/ in front of the device tier
   (stream_io_paths). stream_gateway: two gateway_region(0) full-width
   counter regions (K1), one behind gl.serve_stack(transport="stream")
   (the gateway's default transport: a framed stage graph per accepted
   connection over stream/tcp.py and io/tcp.py), one behind the evloop
   transport; gateway_serve's trace (16 clients x 512 adds, windows of 8,
   depth 4, TCP loopback) in interleaved legs stream, evloop, evloop,
   stream (client_traces seeds 1, 1, 2, 2): no error replies, every reply
   its client's running total, each seed's replies equal across the
   transports, sum_all == acked + warm-up; requests/s and reply p50/p99
   per leg; stop() unbinds the stream transport. streamref_region: two
   provider = remote systems over the in-proc transport; node B offers
   a SourceRef of 32 waves of 256 adds (seed 11) and a SinkRef over the
   wire; node A runs the ref through map_async(4, ask_many_async) into
   the full-width counter region (K1) and the replies back through the
   SinkRef: every reply B receives is the oracle's running total, in
   element order; waves/s and adds/s. hub_region: a MergeHub with 4
   producers (8 waves of 256 adds each, ids of their own) into
   map_async(4) over gateway_region(SLOTS) (K2), the replies out through
   a BroadcastHub to 2 consumers: each sees every reply, each producer's
   in its order, equal to the oracle. K1 and K2 once a region step, held
   to their plain versions on the fullest inboxes; the phase must finish
   within 60 s. `--stream-io-phase N` runs it alone.

Any failure raises and the exit code is non-zero. The last lines are the
kernel report (JSON, one row per kernel and payload dtype; `ms` and the
other top-level numbers are the random pattern's, `patterns` holds every
pattern and path shape, and `launches_by_path` the launches of each path
whose system has that dtype), the card's name and power limit, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import datetime
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from collections import deque
from concurrent.futures import Future
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from akka_tpu_torch import (Actor, ActorSystem, DeadLetter, Props, ask_sync)
from akka_tpu_torch.batched import (BatchedRuntimeHandle, BatchedSystem,
                                    DeviceBlockRef, Emit, LaneSupervisor,
                                    behavior, device_props, get_handle,
                                    reply_dst)
from akka_tpu_torch.batched.bridge import DeviceActorFailed
from akka_tpu_torch.ddata import tensor as ddt
from akka_tpu_torch.event.flight_recorder import (InMemoryFlightRecorder,
                                                  start_trace, stop_trace)
from akka_tpu_torch.event.metrics import MetricsRegistry
from akka_tpu_torch.event.tracing import Tracer
from akka_tpu_torch.gateway import (GatewayClient, RegionBackend,
                                    counter_behavior)
from akka_tpu_torch.models.baseline_benches import (PAYLOAD_W,
                                                    build_cross_shard,
                                                    build_cross_shard_slots,
                                                    build_fan_in,
                                                    build_ping_pong,
                                                    build_ring,
                                                    build_ring_slots,
                                                    build_router,
                                                    build_router_api,
                                                    make_block_ring_behavior,
                                                    ring_behavior,
                                                    seed_ring_full)
from akka_tpu_torch.ops import cuda_mailbox as cm
from akka_tpu_torch.cluster import (Cluster, ClusterRouterGroup,
                                    ClusterRouterGroupSettings, MemberStatus)
from akka_tpu_torch.pattern.ask import ask, pipe
from akka_tpu_torch.pattern.backoff import (BackoffSupervisor,
                                            GetRestartCount,
                                            RestartCount)
from akka_tpu_torch.parallel import (initialize_distributed, make_mesh,
                                     process_group, shutdown_distributed)
from akka_tpu_torch.persistence import (Effect, EventSourcedBehavior,
                                        LocalSnapshotStore, Persistence,
                                        PersistenceId, PersistenceQuery,
                                        RetentionCriteria,
                                        SnapshotSelectionCriteria)
from akka_tpu_torch.remote.provider import RemoteActorRef
from akka_tpu_torch.routing.router import GetRoutees, RoundRobinGroup
from akka_tpu_torch.sharding import (AskBatcher, ClusterShardingTyped,
                                     DeviceEntity, DeviceShardRegion,
                                     EntityTypeKey, GetShardRegionState,
                                     StartEntity,
                                     make_default_extract_shard_id)
from akka_tpu_torch import stream as st
from akka_tpu_torch.stream import DevicePipeline
from akka_tpu_torch.testkit import TestProbe
from akka_tpu_torch.testkit.chaos import CRASH_SALT, chaos_hit_np, inject
from akka_tpu_torch.testkit.cluster import FAST_MEMBERSHIP
from akka_tpu_torch.tools import bench_mailbox as bm
from akka_tpu_torch.tools import gateway_load as gl
from akka_tpu_torch.tools import profile_step as ps
from akka_tpu_torch.tools import serving_gateway as sg
from akka_tpu_torch.tools import trace_export
from akka_tpu_torch.typed import (Behaviors, Find, Listing, Receptionist,
                                  ServiceKey, props_from_behavior)
from akka_tpu_torch.typed import ActorSystem as TypedActorSystem
from akka_tpu_torch.utils.carry import numpy_carry

RTOL, ATOL = bm.RTOL, bm.ATOL
TYPED = (torch.int32, torch.bfloat16)   # payload dtypes besides float32
DTYPE_NAME = {t: name for name, t in bm.DTYPES.items()}
N = 1 << 20                 # actors on the main path
M = N + bm.HOST_ROWS        # inbox rows: n * K emissions + host_inbox
SLOTS = bm.SLOTS
KERNEL_ITERS = 200          # C-entry launches per device timing
STEPS = 20                  # steps per timed run of a main-path system
PAIRS = 3                   # interleaved (graph, eager twin) timed runs
PROFILE_STEPS = 5           # steps under the profiler, graph and eager
WAVES, WAVE_ASKS = 32, 256  # timed ask waves of the region phases
GW_CLIENTS, GW_ENTS, GW_ADDS = 16, 64, 512  # gateway_serve's trace
GW_SLOTS_ADDS = 128        # adds per client of gateway_serve_slots
GW_WARM = 64               # warm-up adds (one each) before the clients
RESTORE_WAVES = 16         # ask waves before and after the checkpoint
LATE_TELLS = 64            # tells staged, not stepped, at the crash
KILL9_SECONDS = 25.0       # the load children's run in gateway_kill9
SUP_WINDOWS = 5            # interleaved timed windows, supervision triple
CHAOS_SEED, CHAOS_RATE = 7, 1e-3  # ring_chaos: inject(seed, crash_rate)
OBS_WINDOWS = 5             # interleaved timed windows, ring_metrics


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def kernel_rows(label: str, inputs, n: int, lib,
                kernels=("K1", "K2"), slots: int = SLOTS) -> dict:
    """`kernels` against their plain versions on `inputs` (integers, int32
    sums included, bit-equal; float32 sums within rtol/atol; bf16 sums
    within one bf16 ulp plus the float32 reordering allowance), then
    timed: the C entry on the card's clock (`ms`), the wrapper, the plain
    version and, for K1, its yardstick `bench_mailbox.library_reduce` (one
    `index_add_`, float32-widened for bf16; held to the plain version
    too). For bf16, K1 also times the bf16 `index_add_` the kernel phase
    timed before and reports whether it computes K1's function
    (`native_agrees`). The bound counts the bytes of this input's accepted
    rows at the payload's element size. K2 keeps `slots` slots."""
    dst, mtype, payload, valid = inputs
    m, n_p, dt = dst.shape[0], payload.shape[1], payload.dtype
    e1, e2, _ = bm.package_entries(lib, inputs, n, slots)
    ok = valid & (dst >= 0) & (dst < n)
    b1, b2 = bm.bound_bytes(m, n, n_p, slots, live=int(ok.sum()),
                            elem=payload.element_size())
    slack = bm.sum_slack(dst, payload, valid, n) \
        if dt == torch.bfloat16 else None
    rows = {}
    if "K1" in kernels:
        want = cm.ring_reduce_plain(dst, payload, valid, n)
        err = bm.compare(f"K1 {label}", cm.ring_reduce(dst, payload, valid, n),
                         want, slack)
        library = bm.library_reduce(dst, payload, valid, n)
        bm.compare(f"library K1 {label}", library(), want, slack)
        torch.cuda.synchronize()
        rows["K1"] = {
            "ms": bm.cuda_ms(e1, KERNEL_ITERS, 5),
            "wrapper_ms": bm.cuda_ms(
                lambda: cm.ring_reduce(dst, payload, valid, n)),
            "plain_ms": bm.cuda_ms(
                lambda: cm.ring_reduce_plain(dst, payload, valid, n)),
            "library_ms": bm.cuda_ms(library),
            "bound_ms": bm.bound_ms(b1), "max_abs_err": err}
        if dt == torch.bfloat16:
            native = bm.library_reduce(dst, payload, valid, n, native=True)
            got = native()
            try:
                bm.compare(f"native library K1 {label}", got, want, slack)
                agrees = True
            except RuntimeError:
                agrees = False
            rows["K1"].update({
                "library_native_ms": bm.cuda_ms(native),
                "native_agrees": agrees,
                "native_max_count": int(got[0].max()),
                "native_max_abs_err": float(
                    (got[1].float() - want[1].float()).abs().max())})
    if "K2" in kernels:
        err = bm.compare(f"K2 {label}", cm.ring_slots(*inputs, n, slots),
                         cm.ring_slots_plain(*inputs, n, slots), slack)
        torch.cuda.synchronize()
        rows["K2"] = {
            "ms": bm.cuda_ms(e2, KERNEL_ITERS, 5),
            "wrapper_ms": bm.cuda_ms(
                lambda: cm.ring_slots(*inputs, n, slots)),
            "plain_ms": bm.cuda_ms(
                lambda: cm.ring_slots_plain(*inputs, n, slots)),
            "library_ms": None,
            "bound_ms": bm.bound_ms(b2), "max_abs_err": err,
            "by_kernel": bm.device_breakdown(e2)}
    for k, row in rows.items():
        print(f"{label} m={m} n={n} {k} " + " ".join(
            f"{f} {v}" for f, v in row.items()))
    return rows


def small_check(dtype, p: int = 3) -> dict:
    """K1 and K2 against their plain versions at a small ragged shape (P =
    4 takes the float4 rows of float32 and bf16, P = 3 and 5 their column
    branch; int32 K1 takes one lane per element at every P); returns
    {kernel: {"max_abs_err": ...}}."""
    dst, mtype, payload, valid = bm.make_pattern("random", 37, 11, p, 37,
                                                 dtype=dtype)
    slack = bm.sum_slack(dst, payload, valid, 11) \
        if dtype == torch.bfloat16 else None
    errs = {"K1": bm.compare(
        "K1 m=37", cm.ring_reduce(dst, payload, valid, 11),
        cm.ring_reduce_plain(dst, payload, valid, 11), slack),
            "K2": bm.compare(
        "K2 m=37", cm.ring_slots(dst, mtype, payload, valid, 11, SLOTS),
        cm.ring_slots_plain(dst, mtype, payload, valid, 11, SLOTS), slack)}
    torch.cuda.synchronize()
    print(f"kernel_check {DTYPE_NAME[dtype]} m=37 n=11 p={p} S={SLOTS}: "
          f"max_abs_err={max(errs.values())}")
    return {k: {"max_abs_err": e} for k, e in errs.items()}


def misaligned_check(dtype, lib) -> dict:
    """K2 at the main path's shape (random traffic) with one operand off
    the alignment its vector branch needs (bench_mailbox.shifted_slots):
    the payload one element past its 4-element word (int32 4 bytes past
    16, bf16 2 past 8), the ring payload `buf_p` one element past, and
    for bf16 the sums (2 bytes past 8) and the float32 accumulator (4
    past 16). The kernels take their column branch for it and must still
    match the plain version; returns {case: {"K2": {"max_abs_err": ...}}}."""
    inputs = bm.make_pattern("random", M, N, PAYLOAD_W, 3, dtype=dtype)
    slack = bm.sum_slack(inputs[0], inputs[2], inputs[3], N) \
        if dtype == torch.bfloat16 else None
    want = cm.ring_slots_plain(*inputs, N, SLOTS)
    cases = ["payload", "buf_p"]
    if dtype == torch.bfloat16:
        cases += ["sums", "acc"]
    errs = {}
    for shift in cases:
        err = bm.compare(f"K2 misaligned {shift}", bm.shifted_slots(
            lib, inputs, N, SLOTS, shift), want, slack)
        torch.cuda.synchronize()
        print(f"kernel_check {DTYPE_NAME[dtype]} K2 m={M} n={N} "
              f"p={PAYLOAD_W} S={SLOTS} misaligned {shift}: "
              f"max_abs_err={err}")
        errs[f"misaligned_{shift}"] = {"K2": {"max_abs_err": err}}
    return errs


def kernel_phase(lib):
    """K1 and K2 at a small ragged shape and, at the main path's shape,
    at each traffic pattern, in float32, int32 and bf16 (int32 and bf16
    also at small shapes with P = 4 and 5, and K2 with misaligned
    operands at the main path's shape; fan-in adds ~1049 rows into
    each collector: a bf16 accumulator would miss the one-ulp check
    there); returns the float32 report rows by pattern and the typed rows
    by dtype name, then pattern."""
    small_check(torch.float32)
    rows = {pattern: kernel_rows(pattern, bm.make_pattern(
                pattern, M, N, PAYLOAD_W, seed), N, lib)
            for seed, pattern in enumerate(bm.PATTERNS)}
    typed = {}
    for dtype in TYPED:
        name = DTYPE_NAME[dtype]
        typed[name] = {f"small_p{p}": small_check(dtype, p)
                       for p in (3, 4, 5)}
        typed[name].update(misaligned_check(dtype, lib))
        for seed, pattern in enumerate(bm.PATTERNS):
            typed[name][pattern] = kernel_rows(
                f"{pattern}_{name}", bm.make_pattern(
                    pattern, M, N, PAYLOAD_W, seed, dtype=dtype), N, lib)
    return rows, typed


def flat_inputs(s):
    """The inputs of a sharded step's one delivery call, as it is about to
    run: the flat inbox of this rank's shards (all of them on one card),
    rows addressed outside their shard masked, recipients as this rank's
    rows, and the recipient count."""
    d, ml = s.local_shards, s.m_local
    dst = s.inbox_dst.view(d, ml)
    own = s.inbox_valid.view(d, ml) & (dst >= s._bases) \
        & (dst < s._bases + s.local_n)
    return ((s.inbox_dst - s.row_lo).clone(), s.inbox_type.clone(),
            s.inbox_payload.clone(), own.reshape(-1).clone()), s.n_rows


class Launches:
    """The kernel launches of one main path: the counts are zeroed just
    before each stretch of the path and read just after it, and summed
    (the eager twin's steps run between the stretches, uncounted)."""

    def __init__(self):
        self.counts = {k: 0 for k in cm.LAUNCHES}

    def __call__(self, fn):
        cm.reset_launches()
        out = fn()
        for k, v in cm.LAUNCHES.items():
            self.counts[k] += v
        return out

    def report(self, label: str, kernel, launches: dict,
               steps=None) -> None:
        """Record the path's counts; it must have launched `kernel`, and
        with `steps`, exactly once per step (kernel None: neither ring
        kernel, not once)."""
        counts = dict(self.counts)
        print(f"{label} launches {counts}")
        if kernel is None:  # a path off the ring kernels
            check(not any(counts.values()), f"{label} launched no ring "
                  f"kernel")
            launches[label] = counts
            return
        check(counts[kernel] > 0, f"{label} launched {kernel}")
        if steps is not None:
            print(f"{label} launches_per_step {counts[kernel] / steps}")
            check(counts[kernel] == steps, f"{label}: {counts[kernel]} "
                  f"{kernel} launches, one per step for all shards "
                  f"({steps})")
        launches[label] = counts


def eager_twin(system):
    """A comparison twin that steps eagerly: the private `_step_impl`
    loop, where the system itself replays its step's CUDA graph."""
    system._eager = True
    return system


def free() -> None:
    """Release a finished phase's systems and their graph pools."""
    gc.collect()
    torch.cuda.empty_cache()


def graph_line(label: str, system) -> None:
    """The phase's captures, their time and the memory the allocator
    holds (carries, graph pools and caches)."""
    torch.cuda.synchronize()
    st = system._graphs.stats()
    print(f"{label} captures {st['captures']} capture_ms "
          f"{st['capture_ms']} warmup_ms {st['warm_ms']} graphs "
          f"{st['graphs']} memory_reserved {torch.cuda.memory_reserved()}")


# median graph ms/step of each step cell (the actor ring prints
# ring_reduce's beside its own)
GRAPH_MS: Dict[str, float] = {}


def timed_pairs(label: str, g, e, steps: int, msgs_per_step: int,
                count: Launches) -> None:
    """PAIRS interleaved timings, graph then eager twin, of run(steps)
    between CUDA events (host-clock spread between calls is large, so
    the two are compared only as neighbours); prints each and the
    medians."""
    times = {"graph": [], "eager": []}
    for _ in range(PAIRS):
        times["graph"].append(count(lambda: bm.cuda_ms(
            lambda: g.run(steps), iters=1, warmup=0)) / steps)
        times["eager"].append(bm.cuda_ms(lambda: e.run(steps), iters=1,
                                         warmup=0) / steps)
    GRAPH_MS[label] = float(np.median(times["graph"]))
    for mode, ts in times.items():
        ms = float(np.median(ts))
        print(f"{label} {mode} ms_per_step {ms} pairs {ts}")
        print(f"{label} {mode} msgs_per_s {msgs_per_step / (ms * 1e-3)}")
    print(f"{label} eager_over_graph "
          f"{np.median(times['eager']) / np.median(times['graph'])}")


def host_launches(label: str, g, e, steps: int, count: Launches,
                  sweeps: bool = False) -> None:
    """The host's CUDA launch calls per step under torch.profiler, graph
    and eager twin. With `sweeps`, the trace must show the ring kernels'
    `ring_sweep` once per replayed step, as the replay counts say."""
    calls, kernels, busy = count(lambda: ps.launch_profile(
        lambda: g.run(steps)))
    print(f"{label} graph host_launch_calls_per_step {calls / steps} "
          f"device_busy_ms_per_step {busy / steps}")
    if sweeps:
        n = sum(c for k, c in kernels.items() if "ring_sweep" in k)
        print(f"{label} profiler ring_sweep {n} over {steps} replayed "
              f"steps ({sum(kernels.values())} kernels traced)")
        check(n == steps, f"{label}: the trace shows ring_sweep {n} times "
              f"for {steps} replayed steps")
    calls, _, busy = ps.launch_profile(lambda: e.run(steps))
    print(f"{label} eager host_launch_calls_per_step {calls / steps} "
          f"device_busy_ms_per_step {busy / steps}")


def check_twin(label: str, g, e, twin: str = "eager twin") -> None:
    """The graph system against a twin, every carry field: integers
    bit-equal, floats within RTOL/ATOL (float atomics add in a
    run-dependent order) and finite."""
    cg, ce = numpy_carry(g), numpy_carry(e)
    check(sorted(cg) == sorted(ce), f"{label}: the same carry fields")
    for k, a in cg.items():
        if a.dtype.kind == "f":
            check(np.isfinite(a).all(), f"{label}: {k} finite")
            check(np.allclose(a, ce[k], rtol=RTOL, atol=ATOL),
                  f"{label} vs {twin}: {k} within tolerance")
        else:
            check(np.array_equal(a, ce[k]),
                  f"{label} vs {twin}: {k} bit-equal")
    print(f"{label} {twin}: {len(cg)} carry fields equal")


def step_cell(label: str, kernel: str, build, launches: dict, check_fn,
              msgs_per_step: int, sweeps: bool = False, after=None,
              seed=seed_ring_full):
    """One step cell: the system on graphs and its eager twin, built and
    seeded alike; warmup() (outside the counted path), a first run of
    STEPS, PAIRS interleaved timed runs, the host launches per step, the
    cell's closed form on the graph system, the twin check, and the
    launch count (once per step by replay count). Returns both."""
    g, e = build(), eager_twin(build())
    for s in (g, e):
        seed(s)
    t0 = time.perf_counter()
    g.warmup()
    print(f"{label} warmup_s {time.perf_counter() - t0}")
    count = Launches()
    count(lambda: g.run(STEPS))
    e.run(STEPS)
    timed_pairs(label, g, e, STEPS, msgs_per_step, count)
    host_launches(label, g, e, PROFILE_STEPS, count, sweeps)
    torch.cuda.synchronize()
    steps = g._host_step
    if after is not None:
        after(g, e)  # a path of its own where it steps
    check_fn(g, steps)
    check_twin(label, g, e)
    graph_line(label, g)
    count.report(label, kernel, launches, steps)
    return g, e


def ring_check(s, steps):
    check((s.read_state("received") == steps).all(),
          "ring: every actor received one token per step")


def single_device_paths(launches: dict) -> None:
    def tells(g, e):
        ring_check(g, g._host_step)  # before the tells add tokens
        before = g.read_state("received")
        told = [0, 5, 7]
        count = Launches()
        for s in (g, e):
            s.tell(told, [1.0, 0.0, 0.0, 0.0])
        count(g.step)
        e.step()
        after = g.read_state("received")
        want = before + 1
        want[told] += 1
        check((after == want).all(), "tell + step: told rows got 2 "
              "messages, others 1")
        count.report("tell_step", "ring_reduce", launches, 1)
        # one step with staged tells: the flush's copies and the replay
        g.tell(told, [1.0, 0.0, 0.0, 0.0])
        e.tell(told, [1.0, 0.0, 0.0, 0.0])
        calls, _, _ = count(lambda: ps.launch_profile(g.step))
        print(f"tell_step graph host_launch_calls_per_step {calls}")
        calls, _, _ = ps.launch_profile(e.step)
        print(f"tell_step eager host_launch_calls_per_step {calls}")

    step_cell("ring_reduce", "ring_reduce", lambda: build_ring(
        N, static=False, device="cuda"), launches,
        lambda s, steps: None, N, sweeps=True, after=tells)
    free()

    def fan_in_check(f, steps):
        msgs = f.read_state("msgs")[:1000]
        total = f.read_state("total")[:1000]
        want = (steps - 1) * N   # deliveries lag the first send a step
        check(int(msgs.sum()) == want, f"fan-in: {int(msgs.sum())} == {want}")
        check(float(total.astype("float64").sum()) == float(want),
              "fan-in: totals == msgs")

    step_cell("fan_in", "ring_reduce", lambda: build_fan_in(
        N, 1000, static=False, device="cuda"), launches, fan_in_check, N,
        seed=lambda s: None)
    free()

    def slots_system(backend=None):
        return build_ring_slots(N, SLOTS, device="cuda",
                                delivery_backend=backend)

    step_cell("ring_slots", "ring_slots", slots_system, launches,
              ring_check, N, after=twin_check("ring_slots", slots_system,
                                              "ranked"))
    free()

    # the ring in int32 and bf16 payloads, on K1 and K2
    for dtype in TYPED:
        name = DTYPE_NAME[dtype]

        def reduce_system(backend=None, dtype=dtype):
            return build_ring(N, static=False, device="cuda",
                              payload_dtype=dtype, delivery_backend=backend)

        def typed_slots(backend=None, dtype=dtype):
            return build_ring_slots(N, SLOTS, device="cuda",
                                    payload_dtype=dtype,
                                    delivery_backend=backend)

        for label, kernel, build in (
                (f"ring_reduce_{name}", "ring_reduce", reduce_system),
                (f"ring_slots_{name}", "ring_slots", typed_slots)):
            step_cell(label, kernel, build, launches, ring_check, N,
                      after=twin_check(label, build, "ranked"))
            free()

    # compiled routing: no ring kernel; held to the dynamic twin
    for label, kind, build, dynamic, check_fn, seed in (
            ("ring_static", "shift", lambda: build_ring(N, device="cuda"),
             lambda _: build_ring(N, static=False, device="cuda"),
             ring_check, seed_ring_full),
            ("fan_in_static", "mod",
             lambda: build_fan_in(N, 1000, device="cuda"),
             lambda _: build_fan_in(N, 1000, static=False, device="cuda"),
             fan_in_check, lambda s: None)):
        g, _ = step_cell(label, None, build, launches, check_fn, N,
                         after=twin_check(label, dynamic, None, seed),
                         seed=seed)
        got = g._core.topology.kind
        print(f"{label} kind {got}")
        check(got == kind, f"{label}: kind {got} == {kind}")
        del g
        free()


def twin_check(label: str, build, backend, seed=seed_ring_full):
    """A step cell's `after`: a twin built with `build(backend)` (the
    ranked kernels, or the dynamic counterpart of a static system), seeded
    and run as many steps as the graph system, must agree with it
    (integers bit-equal)."""
    def after(g, e):
        twin = build(backend)
        seed(twin)
        twin.run(g._host_step)
        check_twin(label, g, twin, "ranked twin" if backend else
                   "dynamic twin")
    return after


def cross_shard_ring_check(label, d):
    """The cross-shard ring's closed form on d shards (all of them this
    rank's): one token a step for every entity, nothing dropped, every
    token in flight and, on several shards, every message across one."""
    def check_fn(x, steps):
        check((x.read_state("received") == steps).all(),
              f"{label}: every entity received one token per step")
        check(x.total_dropped == 0 and x.mailbox_overflow == 0,
              f"{label}: total_dropped == 0")
        pc, sc = x.pair_cap, x.spill_cap
        chunks = x.inbox_valid.view(d, x.m_local)[:, sc:sc + d * pc] \
            .view(d, d, pc)
        check(int(chunks.sum()) == x.capacity, f"{label}: every token "
              "in flight")
        if d > 1:
            check(not bool(chunks.diagonal().any()),
                  f"{label}: every message crossed a shard")
    return check_fn


def sharded_paths(launches: dict) -> dict:
    """The sharded system's paths; returns the 8-shard paths' delivery
    inputs by kernel."""
    flat = {}
    for d, label in ((1, "sharded_ring_d1"), (8, "cross_shard_d8")):
        x, _ = step_cell(label, "ring_reduce", lambda: build_cross_shard(
            256, 4096, n_devices=d, device="cuda"), launches,
            cross_shard_ring_check(label, d), N, sweeps=d == 8)
        if d == 8:
            flat["K1"] = flat_inputs(x)
        del x
        free()

    def slots_system(backend=None):
        return build_cross_shard_slots(256, 4096, n_devices=8, slots=SLOTS,
                                       device="cuda",
                                       delivery_backend=backend)

    def slots_check(r, steps):
        check((r.read_state("received") == steps).all(),
              "sharded slots: every entity received one token per step")
        check(r.total_dropped == 0 and r.mailbox_overflow == 0,
              "sharded slots: nothing dropped")

    r, _ = step_cell("sharded_slots_d8", "ring_slots", slots_system,
                     launches, slots_check, N,
                     after=twin_check("sharded_slots_d8", slots_system,
                                      "ranked"))
    flat["K2"] = flat_inputs(r)
    del r
    free()
    return flat


def make_trace(seed: int = 0, n_waves: int = WAVES + 2):
    """`n_waves` waves of WAVE_ASKS adds (by default one warm wave, WAVES
    timed waves and one profiled wave): 7/8 distinct entities of a
    4096-name pool, the rest repeats of entities already in the wave;
    values are integers 1..9."""
    rng = np.random.default_rng(seed)
    pool = [f"entity-{i}" for i in range(4096)]
    waves = []
    distinct = WAVE_ASKS - WAVE_ASKS // 8
    for _ in range(n_waves):
        names = list(rng.choice(pool, distinct, replace=False))
        names += list(rng.choice(names, WAVE_ASKS - distinct))
        order = rng.permutation(WAVE_ASKS)
        vals = rng.integers(1, 10, WAVE_ASKS).astype(np.float64)
        waves.append([(names[i], float(v)) for i, v in zip(order, vals)])
    return waves


def serve(label: str, slots: int, trace, launches: dict,
          spill: bool = False):
    """The region phase: a region stepping on graphs and its eager twin
    take the same waves in turn (graph, eager, graph, ...; the graph
    region's waves are the counted path). With `spill`, the slots region
    keeps its default spill region (the ranked kernels, no ring kernel).
    Returns the graph region's replies, in order, and its system."""
    g, e = gateway_region(slots, spill), gateway_region(slots, spill)
    eager_twin(e.system)
    t0 = time.perf_counter()
    g.system.warmup()
    print(f"{label} warmup_s {time.perf_counter() - t0}")
    refs = [{n: r.entity_ref(n) for w in trace for n, _ in w}
            for r in (g, e)]
    oracle = {n: 0.0 for n in refs[0]}
    sent = 0.0
    replies = []
    rounds = [0]
    run = g.system.run

    def counted_run(n_steps=1):
        rounds[0] += 1
        run(n_steps)

    g.system.run = counted_run
    count = Launches()

    def on(r, fn):
        """fn() for region r; the graph region's calls are the counted
        main path."""
        return count(fn) if r is g else fn()

    def requests(r, asks):
        i = 0 if r is g else 1
        return [(refs[i][n].shard, refs[i][n].index, [v]) for n, v in asks]

    def ask(r, asks):
        reqs = requests(r, asks)
        t0 = time.perf_counter()
        out = on(r, lambda: r.ask_many(reqs))
        return out, time.perf_counter() - t0

    def wave(asks, timed=None):
        nonlocal sent
        out, dt = ask(g, asks)
        twin, dt_e = ask(e, asks)
        if timed is not None:
            timed["graph"].append(dt)
            timed["eager"].append(dt_e)
        for (n, v), o, t in zip(asks, out, twin):
            check(not isinstance(o, BaseException), f"{label}: {o!r}")
            oracle[n] += v
            sent += v
            check(float(o[0]) == oracle[n], f"{label}: reply {o[0]} == "
                  f"oracle {oracle[n]} for {n}")
            check(np.array_equal(o, t), f"{label}: the eager twin's reply "
                  f"{t} == {o}")
            replies.append(o)

    wave(trace[0])  # warm: allocator, first launches
    times = {"graph": [], "eager": []}
    per_wave_rounds, per_wave_steps = [], []
    for asks in trace[1:WAVES + 1]:
        r0, s0 = rounds[0], g.system._host_step
        wave(asks, times)
        per_wave_rounds.append(rounds[0] - r0)
        per_wave_steps.append(g.system._host_step - s0)
    for mode, ts in times.items():
        ts = np.asarray(ts)
        print(f"{label} {mode} asks_per_s {WAVES * WAVE_ASKS / ts.sum()}")
        print(f"{label} {mode} wave_ms_p50 {np.percentile(ts, 50) * 1e3}")
        print(f"{label} {mode} wave_ms_p99 {np.percentile(ts, 99) * 1e3}")
    print(f"{label} rounds_per_wave {np.mean(per_wave_rounds)} "
          f"steps_per_wave {np.mean(per_wave_steps)}")

    # one more wave each under the profiler: host launch calls per step
    outs = []
    for r, mode in ((g, "graph"), (e, "eager")):
        reqs = requests(r, trace[WAVES + 1])
        start = r.system._host_step
        calls, _, busy = on(r, lambda: ps.launch_profile(
            lambda: outs.append(r.ask_many(reqs))))
        steps = r.system._host_step - start
        print(f"{label} {mode} host_launch_calls_per_step {calls / steps} "
              f"device_busy_ms_per_step {busy / steps} "
              f"(one profiled wave, {steps} steps)")
    for (n, v), o, t in zip(trace[WAVES + 1], *outs):
        oracle[n] += v
        sent += v
        check(float(o[0]) == oracle[n] and np.array_equal(o, t),
              f"{label}: profiled wave")
        replies.append(o)

    name = trace[0][0][0]
    solo = count(lambda: g.ask(refs[0][name].shard, refs[0][name].index,
                               [5.0]))
    twin = e.ask(refs[1][name].shard, refs[1][name].index, [5.0])
    oracle[name] += 5.0
    sent += 5.0
    check(float(solo[0]) == oracle[name] and np.array_equal(solo, twin),
          f"{label}: solo ask")
    replies.append(solo)

    moved = refs[0][name].shard
    old_row = refs[0][name].row
    for r in (g, e):
        on(r, lambda: r.rebalance(moved))
    check(refs[0][name].row != old_row, f"{label}: the shard moved")
    wave([(n, 1.0) for n in refs[0] if refs[0][n].shard == moved])
    sys_ = g.system
    rows = np.asarray([r.row for r in refs[0].values()], np.int64)
    totals = sys_.read_state("total", rows)
    check(all(float(t) == oracle[n] for t, n in zip(totals, refs[0])),
          f"{label}: totals == oracle after rebalance")
    live = sys_.alive.cpu().numpy()  # the moved block's old copy is dead
    check(float(sys_.read_state("total")[live].astype(np.float64).sum())
          == sent, f"{label}: totals conserved ({sent})")
    check(g.ask_pool_stats()["in_flight"] == 0,
          f"{label}: no ask left in flight")
    check_twin(label, sys_, e.system)
    graph_line(label, sys_)
    print(f"{label} asks {len(replies)} entities {len(refs[0])} "
          f"steps {sys_._host_step}")
    if spill:
        count.report(label, None, launches)
    else:
        kernel = "ring_slots" if slots else "ring_reduce"
        count.report(label, kernel, launches, sys_._host_step)
    return replies, sys_


def region_paths(launches: dict) -> dict:
    """region_serve, region_serve_slots and region_serve_spill (2 slots
    and the default spill region: the ranked kernels at full width) on
    one trace; returns the region's delivery inputs as a wave's tells
    land, by kernel."""
    trace = make_trace()
    flat = {}
    replies = {}
    for label, slots, spill in (("region_serve", 0, False),
                                ("region_serve_slots", SLOTS, False),
                                ("region_serve_spill", SLOTS, True)):
        t0 = time.perf_counter()
        out, sys_ = serve(label, slots, trace, launches, spill)
        print(f"{label} phase_s {time.perf_counter() - t0}")
        replies[label] = out
        if spill:
            check(sys_.spill_cap > 0, f"{label}: a spill region")
            del sys_
            free()
            continue
        # the first step's inbox of a wave: its tells flushed in
        for i in range(WAVE_ASKS):
            sys_.tell(i * 4099 % sys_.capacity,
                      [1.0, 0.0, 0.0, float(sys_.capacity - 1)])
        sys_._flush_staged()
        flat["K2" if slots else "K1"] = flat_inputs(sys_)
        del sys_
        free()
    a = replies["region_serve"]
    for label in ("region_serve_slots", "region_serve_spill"):
        b = replies[label]
        check(len(a) == len(b) and all(np.array_equal(x, y)
                                       for x, y in zip(a, b)),
              f"{label} replies bit-equal to region_serve's")
    return flat


def gateway_region(slots: int, spill: bool = False,
                   metrics: bool = False) -> DeviceShardRegion:
    """The full-width counter region of the region and gateway phases; a
    slots region is bounded (spill_capacity=0) unless `spill`; `metrics`
    compiles the metric slab into its step."""
    return DeviceShardRegion(DeviceEntity(
        "counter", counter_behavior(PAYLOAD_W), n_shards=256,
        entities_per_shard=4096, n_devices=1, spare_blocks=2,
        mailbox_slots=slots,
        spill_capacity=0 if slots and not spill else None,
        metrics_enabled=metrics), device="cuda")


def gateway_serve(label: str, region, continuous: bool, traces,
                  durable: bool = False):
    """One gateway phase on a fresh region whose step graph is already
    captured (before the front end's threads start): a warm-up wave, then
    the clients' trace over TCP. With `durable`, the region has both
    journals attached with an fsync per record (tell) and per wave
    (entity events). Returns (LoadResult, the region's steps, the
    region's delivery inputs as a window's tells land)."""
    directory = tempfile.mkdtemp(prefix="chip_smoke_") if durable else None
    if durable:
        region.attach_journal(directory, fsync_every_n=1)
        region.attach_entity_journal(directory, fsync_every_n=1)
    backend, srv = gl.serve_stack(region, continuous=continuous)
    try:
        warm = backend.ask_many([f"warm-{i}" for i in range(GW_WARM)],
                                [1.0] * GW_WARM)
        check(warm == [1.0] * GW_WARM, f"{label}: warm-up replies")
        if durable:
            wal0 = sum(1 for _ in region._journal.records())
            ej0 = region._entity_journal.stats()
        res = gl.drive(srv.host, srv.port, traces)
        check(not res.errors, f"{label}: no error replies "
              f"({res.errors[:3]})")
        want = sum(len(w) for t in traces for w in t)
        check(res.requests == want, f"{label}: {res.requests} acked "
              f"of {want} adds")
        check(gl.running_totals_hold(res), f"{label}: every reply equals "
              "its client's running total")
        check(backend.batcher.quiesce(60.0), f"{label}: quiesce")
        total = backend.sum_all()
        check(total == res.acked + GW_WARM, f"{label}: sum_all {total} == "
              f"acked {res.acked} + warm-up {GW_WARM}")
        check(region.ask_pool_stats()["in_flight"] == 0,
              f"{label}: no ask in flight after quiesce")
        st = backend.batcher.stats()
        agg = srv.aggregator.stats()
        lat = np.asarray(res.latencies) * 1e3
        print(f"{label} requests {res.requests} seconds {res.seconds}")
        print(f"{label} requests_per_s {res.requests / res.seconds}")
        print(f"{label} reply_ms_p50 {np.percentile(lat, 50)} "
              f"reply_ms_p99 {np.percentile(lat, 99)} "
              f"(per window of 8, client side)")
        print(f"{label} waves {st['batches']} mean_wave "
              f"{st['mean_batch_size']} overlap_ratio {st['overlap_ratio']}")
        print(f"{label} ingest_windows {agg['windows']} mean_window "
              f"{agg['mean_window_size']} sheds {res.sheds}")
        steps = region.system._host_step
        print(f"{label} steps {steps}")
        if durable:
            # one fsync per WAL record (every staged tell) and per entity
            # journal wave
            wal = sum(1 for _ in region._journal.records()) - wal0
            ej = region._entity_journal.stats()
            ej_fsyncs = ej["fsyncs"] - ej0["fsyncs"]
            check(region._entity_journal.totals() ==
                  {**{f"warm-{i}": 1.0 for i in range(GW_WARM)},
                   **{e: t for rs in res.replies for e, _, t in rs}},
                  f"{label}: the entity journal's fold == the acked "
                  "totals")
            print(f"{label} wal_fsyncs {wal} entity_journal_fsyncs "
                  f"{ej_fsyncs} entity_journal_waves "
                  f"{ej['waves'] - ej0['waves']}")
            print(f"{label} fsyncs_per_256_requests "
                  f"{(wal + ej_fsyncs) * 256 / res.requests}")
        # host launch calls per step, every thread's, over a short extra
        # load (not counted in the numbers above)
        s0 = region.system._host_step
        box = []
        calls, _, busy = ps.launch_profile(lambda: box.append(gl.drive(
            srv.host, srv.port, gl.client_traces(99, GW_CLIENTS, 8, 16))))
        check(not box[0].errors and gl.running_totals_hold(box[0]),
              f"{label}: the profiled load's replies")
        check(backend.batcher.quiesce(60.0), f"{label}: quiesce")
        n = region.system._host_step - s0
        print(f"{label} host_launch_calls_per_step {calls / n} "
              f"device_busy_ms_per_step {busy / n} (profiled load, "
              f"{box[0].requests} requests, {n} steps)")
        graph_line(label, region.system)
        # a window's tells as they land: the delivery call's inputs
        sys_ = region.system
        for i in range(64):
            sys_.tell(i * 4099 % sys_.capacity,
                      [1.0, 0.0, 0.0, float(sys_.capacity - 1)])
        sys_._flush_staged()
        flat = flat_inputs(sys_)
    finally:
        srv.stop()
        backend.close()
        if directory is not None:
            shutil.rmtree(directory, ignore_errors=True)
    return res, steps, flat


def gateway_paths(launches: dict) -> dict:
    """gateway_serve, its durable and serialized twins and
    gateway_serve_slots; returns the gateway region's delivery inputs by
    kernel."""
    traces = gl.client_traces(1, GW_CLIENTS, GW_ENTS, GW_ADDS)
    runs, flat = {}, {}
    short = [t[:GW_SLOTS_ADDS // 8] for t in traces]
    for label, slots, continuous, trace, kernel, durable in (
            ("gateway_serve", 0, True, traces, "ring_reduce", False),
            ("gateway_serve_durable", 0, True, traces, "ring_reduce", True),
            ("gateway_serve_serialized", 0, False, traces, "ring_reduce",
             False),
            ("gateway_serve_slots", SLOTS, True, short, "ring_slots",
             False)):
        t0 = time.perf_counter()
        region = gateway_region(slots)
        region.system.warmup()  # before the front end's threads start
        count = Launches()
        res, steps, inputs = count(lambda: gateway_serve(
            label, region, continuous, trace, durable))
        # the profiled load's steps launch too: count them all
        count.report(label, kernel, launches, region.system._host_step)
        print(f"{label} phase_s {time.perf_counter() - t0}")
        runs[label] = res
        flat["K2" if slots else "K1"] = inputs
        del region
        free()
    main = runs["gateway_serve"].replies
    check(runs["gateway_serve_serialized"].replies == main,
          "gateway_serve_serialized: the same replies as gateway_serve")
    check(runs["gateway_serve_durable"].replies == main,
          "gateway_serve_durable: the same replies as gateway_serve")
    check(runs["gateway_serve_serialized"].acked ==
          runs["gateway_serve"].acked, "gateway_serve_serialized: totals")
    slots_replies = runs["gateway_serve_slots"].replies
    check(all(s == m[:len(s)] for s, m in zip(slots_replies, main)),
          "gateway_serve_slots: the replies gateway_serve gave the same "
          "requests")
    return flat


def ask_waves(region, trace, oracle: dict, label: str) -> None:
    """Each wave through `ask_many`; every reply must equal the oracle's
    running total (which it advances)."""
    for asks in trace:
        refs = [region.entity_ref(n) for n, _ in asks]
        out = region.ask_many([(r.shard, r.index, [v])
                               for r, (_, v) in zip(refs, asks)])
        for (n, v), o in zip(asks, out):
            check(not isinstance(o, BaseException), f"{label}: {o!r}")
            oracle[n] = oracle.get(n, 0.0) + v
            check(float(o[0]) == oracle[n], f"{label}: reply {o[0]} == "
                  f"oracle {oracle[n]} for {n}")


def restore_phase(label: str, slots: int, kernel: str, trace,
                  launches: dict) -> None:
    """A journaled region (tell WAL + entity journal) and its
    uninterrupted twin take the same traffic: RESTORE_WAVES ask waves, a
    rebalance (which drains the hand-off window and checkpoints, as the
    reference does), the timed checkpoint(), RESTORE_WAVES more waves,
    and LATE_TELLS tells to entities first allocated after the
    checkpoint, staged but not stepped. The journaled region is dropped
    without a goodbye; a fresh region on the same directory restores
    (launch counts zeroed just before restore(), read just after) and
    must equal the twin (after its 2-step flush) and the host oracle,
    entity by entity."""
    directory = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        twin = gateway_region(slots)
        victim = gateway_region(slots)
        victim.attach_journal(directory)
        victim.attach_entity_journal(directory)
        oracles = ({}, {})
        first, second = trace[1:1 + RESTORE_WAVES], \
            trace[1 + RESTORE_WAVES:1 + 2 * RESTORE_WAVES]
        for r, o in zip((twin, victim), oracles):
            ask_waves(r, first, o, label)
            r.rebalance(r.entity_ref(first[0][0][0]).shard)
        t0 = time.perf_counter()
        snap = victim.checkpoint()
        ckpt_ms = (time.perf_counter() - t0) * 1e3
        snap_bytes = os.path.getsize(snap)
        late = [(f"late-{i}", float(i % 7 + 1)) for i in range(LATE_TELLS)]
        for r, o in zip((twin, victim), oracles):
            ask_waves(r, second, o, label)
            for n, v in late:
                r.entity_ref(n).tell([v, 0.0, 0.0, -1.0])
                o[n] = o.get(n, 0.0) + v
        twin.run(2)  # the twin applies the staged tells
        oracle = oracles[0]
        check(oracles[1] == oracle, f"{label}: both regions' replies")
        crash_step = victim.system._host_step
        del victim  # the crash: no close, no sync, no goodbye

        fresh = gateway_region(slots)
        fresh.attach_journal(directory)
        fresh.attach_entity_journal(directory)
        t0 = time.perf_counter()
        fresh.system.warmup()  # a same-shape restore keeps the graph
        warm_ms = (time.perf_counter() - t0) * 1e3
        cm.reset_launches()
        t0 = time.perf_counter()
        step = fresh.restore()
        fresh.block_until_ready()
        restore_ms = (time.perf_counter() - t0) * 1e3
        counts = dict(cm.LAUNCHES)
        timing = fresh.restore_timings
        names = sorted(oracle)
        got = fresh.system.read_state(
            "total", np.asarray([fresh.entity_ref(n).row for n in names]))
        want = twin.system.read_state(
            "total", np.asarray([twin.entity_ref(n).row for n in names]))
        check(step == crash_step, f"{label}: restored step {step} == "
              f"crash step {crash_step}")
        check(all(float(g) == oracle[n] for g, n in zip(want, names)),
              f"{label}: the twin's totals == the host oracle's")
        check(np.array_equal(got, want), f"{label}: every restored "
              f"total == the twin's ({len(names)} entities)")
        check(fresh._durable_replayed_totals ==
              {n: t for n, t in oracle.items() if not n.startswith("late-")},
              f"{label}: the entity journal's fold == the acked totals")
        check(bool(torch.isfinite(fresh.system.state["total"]).all()),
              f"{label}: finite totals")
        replayed = int(timing["replayed_steps"])
        print(f"{label} rows {fresh.system.capacity} entities "
              f"{len(names)} snapshot_bytes {snap_bytes} checkpoint_ms "
              f"{ckpt_ms}")
        print(f"{label} restore_ms {restore_ms} load_ms {timing['load_ms']} "
              f"h2d_ms {timing['h2d_ms']} replay_ms {timing['replay_ms']} "
              f"replayed_steps {replayed} step {step} (warmup before it "
              f"{warm_ms} ms)")
        print(f"{label} launches {counts}")
        graph_line(label, fresh.system)
        check(fresh.system._graphs.stats()["captures"] == 1,
              f"{label}: the restore replayed the warmed graph")
        check(counts[kernel] == replayed > 0, f"{label}: {counts[kernel]} "
              f"{kernel} launches, one per replayed step ({replayed})")
        launches[label] = counts
        del fresh, twin
        free()
    finally:
        shutil.rmtree(directory, ignore_errors=True)


def kill9_phase(launches: dict) -> None:
    """gateway_kill9: a durable, deduplicating `serving_gateway serve`
    child (full width) and two `load` children; the server is SIGKILLed
    mid-load and restarted with --restore on the same port and
    directory. acked_sum <= final_total <= sent_sum must hold, the
    restored child's replay must have launched K1, and the `durable`
    admin op must report the respawned entities."""
    directory = tempfile.mkdtemp(prefix="chip_smoke_")
    seconds = KILL9_SECONDS
    extra = ["--shards", "256", "--eps", "4096", "--rate", "400",
             "--burst", "200"]
    serve = sg._child(sg.serve_argv("cuda", directory, extra=extra))
    loads, admin = [], None
    try:
        port = sg._wait_ready(serve, 300.0)
        loads = [sg._child(["load", "--port", str(port), "--tenant",
                            f"k9-{i}", "--seconds", str(seconds),
                            "--pace", "0.005"]) for i in (0, 1)]
        admin = GatewayClient("127.0.0.1", port, timeout=30.0)
        before = sg._wait_sum_above(admin, 0.0, 120.0)
        time.sleep(seconds * 0.3)
        sg._wait_sum_above(admin, before, 120.0)
        admin.close()
        seen = []
        serve, secs = sg.kill9_restart(serve, sg.serve_argv(
            "cuda", directory, port, restore=True, extra=extra), 300.0,
            seen)
        fields = sg.restored_fields(seen)
        print(f"gateway_kill9 sigkill_to_ready_s {secs}")
        print(f"gateway_kill9 restored {fields}")
        durable = admin.request_retry("__admin", "", "durable",
                                      deadline_s=60.0)
        check(durable.get("status") == "ok", f"gateway_kill9: {durable}")
        respawned = durable["data"]["replayed_entities"]
        check(respawned > 0 and respawned == fields["respawned"],
              f"gateway_kill9: durable reports {respawned} respawned")
        results = []
        for p in loads:
            out = p.communicate(timeout=seconds + 300)[0]
            results += [json.loads(line) for line in out.splitlines()
                        if line.startswith("{")]
        check(len(results) == 2, "gateway_kill9: both loads reported")
        sent = sum(r["sent_sum"] for r in results)
        acked = sum(r["acked_sum"] for r in results)
        total = float(admin.request_retry("__admin", "", "sum",
                                          deadline_s=60.0)["value"])
        print(f"gateway_kill9 sent_sum {sent} acked_sum {acked} "
              f"final_total {total} loads {results}")
        check(acked <= total <= sent, "gateway_kill9: acked_sum <= "
              "final_total <= sent_sum")
        counts = fields["launches"]
        check(counts["ring_reduce"] > 0 and
              counts["ring_reduce"] == fields["replayed_steps"],
              f"gateway_kill9: the restored server's replay launched K1 "
              f"once per step ({counts})")
        launches["gateway_kill9_restore"] = counts
    finally:
        if admin is not None:
            admin.close()
        for p in loads:
            if p.poll() is None:
                p.kill()
                p.wait()
        serve.send_signal(signal.SIGTERM)
        try:
            serve.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            serve.kill()
            serve.wait()
        shutil.rmtree(directory, ignore_errors=True)


def durability_paths(launches: dict) -> None:
    """region_restore, region_restore_slots and gateway_kill9."""
    trace = make_trace(1)
    for label, slots, kernel in (("region_restore", 0, "ring_reduce"),
                                 ("region_restore_slots", SLOTS,
                                  "ring_slots")):
        t0 = time.perf_counter()
        restore_phase(label, slots, kernel, trace, launches)
        print(f"{label} phase_s {time.perf_counter() - t0}")
    t0 = time.perf_counter()
    kill9_phase(launches)
    print(f"gateway_kill9 phase_s {time.perf_counter() - t0}")


def chaos_oracle(steps: int) -> int:
    """The crashes `inject(seed=7, crash_rate=1e-3)` schedules on the
    seeded ring over `steps` steps: a lane runs while it holds a token,
    and a crash discards its emission (the default supervisor restarts
    it in the same step), so its token is gone."""
    lanes = np.arange(N, dtype=np.uint32)
    tok = np.ones(N, bool)
    failed = 0
    for t in range(steps):
        hit = chaos_hit_np(CHAOS_SEED, t, lanes, CHAOS_RATE, CRASH_SALT) \
            & tok
        failed += int(hit.sum())
        tok = np.roll(tok & ~hit, 1)
    return failed


def supervision_paths(launches: dict) -> None:
    """The reference's supervision bench (bench.py bench_supervision) as
    graphs at 2^20 actors: the bare dynamic ring (ring_plain), the ring
    with LaneSupervisor() (ring_supervised) and the supervised ring with
    crashes injected at 1e-3 per lane and step (ring_chaos). Timed in
    SUP_WINDOWS interleaved windows of STEPS steps (best of each); the
    quiet run's counters must stay zero and the chaos run's `failed`
    must equal the count chaos_hit_np schedules for the lanes that ran,
    every failure restarted."""
    sup_ring = dataclasses.replace(ring_behavior,
                                   supervisor=LaneSupervisor())
    variants = (("ring_plain", ring_behavior), ("ring_supervised", sup_ring),
                ("ring_chaos", inject(sup_ring, seed=CHAOS_SEED,
                                      crash_rate=CHAOS_RATE)))
    systems, counts, best = {}, {}, {}
    for label, b in variants:
        s = BatchedSystem(capacity=N, behaviors=[b], payload_width=PAYLOAD_W,
                          host_inbox=8, device="cuda")
        s.spawn_block(b, N)
        seed_ring_full(s)
        t0 = time.perf_counter()
        s.warmup()
        print(f"{label} warmup_s {time.perf_counter() - t0}")
        systems[label], counts[label], best[label] = s, Launches(), \
            float("inf")
    for _ in range(SUP_WINDOWS):
        for label, s in systems.items():
            ms = counts[label](lambda: bm.cuda_ms(
                lambda: s.run(STEPS), iters=1, warmup=0)) / STEPS
            best[label] = min(best[label], ms)
    for label, s in systems.items():
        print(f"{label} graph ms_per_step {best[label]}")
        graph_line(label, s)
    plain = best["ring_plain"]
    for label in ("ring_supervised", "ring_chaos"):
        print(f"{label} overhead_pct "
              f"{(best[label] - plain) / plain * 100.0}")
    steps = systems["ring_chaos"]._host_step
    for label in ("ring_plain", "ring_supervised"):
        ring_check(systems[label], steps)
    quiet = systems["ring_supervised"].supervision_counts
    check(not any(quiet.values()), f"ring_supervised: quiet counters {quiet}")
    chaos = systems["ring_chaos"].supervision_counts
    want = chaos_oracle(steps)
    print(f"ring_chaos counts {chaos} scheduled_failures {want} "
          f"steps {steps}")
    check(chaos["failed"] > 0 and chaos["restarted"] == chaos["failed"]
          == want, f"ring_chaos: failed {chaos['failed']} == restarted "
          f"{chaos['restarted']} == chaos_hit_np's {want}")
    for label, s in systems.items():
        counts[label].report(label, "ring_reduce", launches, s._host_step)
    del systems, s
    free()


def ring_metrics(launches: dict) -> None:
    """The reference's metrics-overhead bench (bench.py
    bench_metrics_overhead) as graphs at 2^20 actors: the dynamic ring
    with the slab off and on, quiet and active, timed in OBS_WINDOWS
    interleaved windows of STEPS steps (best and median of each). The
    quiet slab must stay empty (epoch 0, no drain); the active one must
    drain once, equal to read_metrics() and to an eager twin's lanes, with
    one message per actor and step in bucket 1 of mailbox_occupancy."""
    variants = (("quiet_off", False, False), ("quiet_on", True, False),
                ("active_off", False, True), ("active_on", True, True))
    systems, counts, times = {}, {}, {}

    def build(metrics, seeded):
        s = BatchedSystem(capacity=N, behaviors=[ring_behavior],
                          payload_width=PAYLOAD_W, host_inbox=8,
                          metrics_enabled=metrics, device="cuda")
        s.spawn_block(ring_behavior, N)
        if seeded:
            seed_ring_full(s)
        return s

    for label, metrics, seeded in variants:
        s = build(metrics, seeded)
        t0 = time.perf_counter()
        s.warmup()
        print(f"ring_metrics {label} warmup_s {time.perf_counter() - t0}")
        systems[label], counts[label], times[label] = s, Launches(), []
    for _ in range(OBS_WINDOWS):
        for label, s in systems.items():
            times[label].append(counts[label](lambda: bm.cuda_ms(
                lambda: s.run(STEPS), iters=1, warmup=0)) / STEPS)
    best = {label: min(ts) for label, ts in times.items()}
    for label, ts in times.items():
        print(f"ring_metrics {label} ms_per_step {best[label]} median "
              f"{float(np.median(ts))} windows {ts}")
    for kind in ("quiet", "active"):
        off, on = best[f"{kind}_off"], best[f"{kind}_on"]
        print(f"ring_metrics {kind}_overhead_pct {(on - off) / off * 100.0}")
    # where the slab's time goes: device ms per step by kernel, profiled
    # over PROFILE_STEPS single-step runs (after one warm run)
    for label in ("active_off", "active_on"):
        s = systems[label]
        ms = counts[label](lambda: bm.device_breakdown(
            lambda: s.run(1), calls=PROFILE_STEPS))
        top = sorted(((k, v) for k, v in ms.items()
                      if not k.startswith("akka.")), key=lambda kv: -kv[1])
        print(f"ring_metrics {label} device_ms_per_step "
              f"{sum(v for _, v in top)} by_kernel {dict(top[:8])}")

    quiet = systems["quiet_on"]
    check(quiet.metrics_epoch_value() == 0, "ring_metrics: the quiet-on "
          "epoch stays 0")
    check(quiet.drain_metrics() is None, "ring_metrics: no quiet drain")
    on = systems["active_on"]
    steps = on._host_step
    drained = on.drain_metrics()
    check(drained is not None and drained[0] == steps,
          f"ring_metrics: the active-on drain at step {steps}")
    lanes = drained[1]
    read = on.read_metrics()
    check(sorted(lanes) == sorted(read) and all(
        np.array_equal(lanes[k], read[k]) for k in read),
        "ring_metrics: the drained lanes == read_metrics()")
    total = sum(int(v.sum()) for v in read.values())
    check(on.metrics_epoch_value() == total, "ring_metrics: the epoch is "
          "the slab's sum")
    check(on.drain_metrics() is None, "ring_metrics: a second drain is "
          "gated")
    occ = lanes["mailbox_occupancy"]
    check(int(occ[1]) == int(occ.sum()) == N * steps, "ring_metrics: one "
          "message per actor and step in mailbox_occupancy bucket 1")
    check(int(lanes["sojourn_steps"].sum()) > 0, "ring_metrics: "
          "sojourn_steps sampled")
    twin = eager_twin(build(True, True))
    twin.run(steps)
    twin_drain = twin.drain_metrics()
    check(twin_drain is not None and twin_drain[0] == steps and all(
        np.array_equal(twin_drain[1][k], lanes[k]) for k in lanes),
        "ring_metrics: the graph's lanes == the eager twin's")
    check(twin.metrics_epoch_value() == total, "ring_metrics: the eager "
          "twin's epoch")
    sums = {k: int(v.sum()) for k, v in lanes.items()}
    print(f"ring_metrics active_on lanes {sums} epoch {total} steps {steps}")
    for label, s in systems.items():
        if label.startswith("active"):
            ring_check(s, steps)
        graph_line(f"ring_metrics_{label}", s)
        counts[label].report(f"ring_metrics_{label}", "ring_reduce",
                             launches, s._host_step)
    del systems, s, on, quiet, twin


def region_observed(launches: dict) -> None:
    """region_serve's region observed: the metric slab on, a Tracer
    sampling every trace, a MetricsRegistry on the entity journal and on
    the ask engine, an InMemoryFlightRecorder on the system. The first
    wave is traced; the WAVES timed waves are traced and untraced in turn
    (asks/s of each). Then the spans and events export to Perfetto, the
    slab drains into the registry, and the registry's two sinks start and
    stop."""
    label = "region_observed"
    trace = make_trace()
    directory = tempfile.mkdtemp(prefix="chip_smoke_")
    reg = MetricsRegistry()
    try:
        region = gateway_region(0, metrics=True)
        sys_ = region.system
        fr = InMemoryFlightRecorder(capacity=1 << 16)
        sys_.flight_recorder = fr
        region.attach_entity_journal(directory, registry=reg)
        batcher = AskBatcher(region, max_batch=WAVE_ASKS, registry=reg)
        tracer = Tracer(sample_rate=1.0, seed=7, capacity=1 << 17)
        t0 = time.perf_counter()
        sys_.warmup()
        print(f"{label} warmup_s {time.perf_counter() - t0}")
        refs = {n: region.entity_ref(n) for w in trace for n, _ in w}
        oracle = {n: 0.0 for n in refs}
        count = Launches()
        steps0 = sys_._host_step
        times = {"traced": [], "untraced": []}
        traced_waves = 0
        for i, asks in enumerate(trace[:WAVES + 1]):
            traced = i % 2 == 0  # the warm wave, then every other one
            region.attach_tracer(tracer if traced else None)
            reqs = [(refs[n].shard, refs[n].index, [v]) for n, v in asks]
            t0 = time.perf_counter()
            roots = [tracer.begin("gw.request", tracer.start_trace(),
                                  parent=0) for _ in asks] if traced else []
            ctxs = [r.ctx for r in roots] if traced else None
            out = count(lambda: batcher.ask_many(reqs, ctxs=ctxs))
            for r in roots:
                r.finish()
            dt = time.perf_counter() - t0
            traced_waves += traced
            if i > 0:
                times["traced" if traced else "untraced"].append(dt)
            for (n, v), o in zip(asks, out):
                check(not isinstance(o, BaseException), f"{label}: {o!r}")
                oracle[n] += v
                check(float(o[0]) == oracle[n], f"{label}: reply {o[0]} == "
                      f"oracle {oracle[n]} for {n}")
        region.attach_tracer(None)
        steps = sys_._host_step - steps0
        rate = {m: len(ts) * WAVE_ASKS / sum(ts) for m, ts in times.items()}
        for m, ts in times.items():
            print(f"{label} {m} asks_per_s {rate[m]} wave_ms_p50 "
                  f"{np.percentile(ts, 50) * 1e3} waves {len(ts)}")
        slower = (rate["untraced"] - rate["traced"]) / rate["untraced"]
        print(f"{label} tracing_overhead_pct {slower * 100.0}")

        spans, events = tracer.spans(), fr.events()
        doc = trace_export.to_perfetto(spans, events)
        errs = trace_export.validate_trace(doc)
        print(f"{label} spans {len(spans)} recorder_events {len(events)} "
              f"perfetto_events {len(doc['traceEvents'])} "
              f"validate_errors {len(errs)}")
        check(not errs, f"{label}: the Perfetto document validates "
              f"({errs[:3]})")
        names = [s["name"] for s in spans]
        check(names.count("ask.wave") == traced_waves and
              names.count("ask.member") == traced_waves * WAVE_ASKS and
              names.count("gw.request") == traced_waves * WAVE_ASKS,
              f"{label}: one wave span per traced wave and one member "
              f"span per traced ask")
        waves = [s for s in spans if s["name"] == "ask.wave"
                 or s["name"].startswith("wave.")]
        check(all(steps0 <= s["step0"] <= s["step1"] <= sys_._host_step
                  for s in waves), f"{label}: every wave span's step "
              f"stamps lie on the region's step axis")
        rounds = [s for s in waves if s["name"] == "wave.step_round"]
        check(rounds and all(s["step1"] - s["step0"] == s["n_steps"] and
                             s["host_step"] == s["step1"] for s in rounds),
              f"{label}: every step round spans its own steps")
        ran = sum(e["n_steps"] for e in events if e["event"] == "device_step")
        check(ran == steps, f"{label}: device_step events add up to {ran} "
              f"steps, the system ran {steps}")

        drained = sys_.drain_metrics()
        check(drained is not None and drained[0] == sys_._host_step,
              f"{label}: the slab drains at the system's step")
        step, lanes = drained
        reg.ingest_device_slab(lanes, step)
        text = reg.expose()
        occ = int(lanes["mailbox_occupancy"].sum())
        check(occ > 0 and all(
            f"akka_device_{k}_count {int(v.sum())}" in text
            for k, v in lanes.items()), f"{label}: expose() holds the "
            "device lanes")
        for series in ("akka_gateway_ask_batch_size_count",
                       "akka_ask_batch_batches",
                       "akka_entity_journal_batch_size_count"):
            check(series in text, f"{label}: expose() holds {series}")
        sums = {k: int(v.sum()) for k, v in lanes.items()}
        print(f"{label} lanes {sums} step {step} expose_lines "
              f"{len(text.splitlines())}")

        port = reg.serve_http(0)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=30) as resp:
            body = resp.read().decode()
        check(f"akka_device_mailbox_occupancy_count {occ}" in body,
              f"{label}: the HTTP scrape holds the device lanes")
        path = os.path.join(directory, "metrics", "metrics.jsonl")
        reg.start_jsonl(path, interval_s=0.05)
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and (
                not os.path.exists(path) or
                sum(1 for _ in open(path)) < 2):
            time.sleep(0.05)
        threads = (reg._http_thread, reg._jsonl_thread)
        reg.close()
        check(all(t is not None and not t.is_alive() for t in threads),
              f"{label}: close() joined the HTTP and JSONL threads")
        with open(path) as fh:
            rows = [json.loads(line) for line in fh if line.strip()]
        check(len(rows) >= 3 and rows[-1]["device"][
            "device_mailbox_occupancy"]["count"] == occ,
            f"{label}: the JSONL rows ({len(rows)}) end with the lanes")
        print(f"{label} http_bytes {len(body)} jsonl_rows {len(rows)}")
        check(region.ask_pool_stats()["in_flight"] == 0,
              f"{label}: no ask left in flight")
        batcher.close()
        graph_line(label, sys_)
        count.report(label, "ring_reduce", launches, steps)
        del region, sys_, batcher
    finally:
        reg.close()
        shutil.rmtree(directory, ignore_errors=True)


def profiler_trace(launches: dict) -> None:
    """start_trace, run(STEPS) on the dynamic ring at 2^20 actors,
    stop_trace: both must return True, and the Chrome trace written must
    hold the run's akka.device.run[STEPS] range and K1's ring_sweep
    kernels, none before the range began."""
    s = build_ring(N, static=False, device="cuda")
    seed_ring_full(s)
    s.warmup()
    count = Launches()
    count(lambda: s.run(STEPS))
    directory = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    try:
        torch.cuda.synchronize()
        started = start_trace(directory)
        time.sleep(ps.TRACE_MARGIN_S)
        count(lambda: s.run(STEPS))
        torch.cuda.synchronize()
        time.sleep(ps.TRACE_MARGIN_S)
        stopped = stop_trace()
        check(started and stopped, f"profiler_trace: start_trace "
              f"{started}, stop_trace {stopped}")
        check(stop_trace() is False, "profiler_trace: no second stop")
        files = [f for f in os.listdir(directory) if f.endswith(".json")]
        check(len(files) == 1, f"profiler_trace: one trace file ({files})")
        with open(os.path.join(directory, files[0])) as fh:
            evs = json.load(fh).get("traceEvents", [])
        name = f"akka.device.run[{STEPS}]"
        ranges = [e for e in evs if e.get("name") == name]
        host = [e for e in ranges if e.get("cat") == "user_annotation"]
        kernels = [e for e in evs if e.get("cat") == "kernel"
                   and "ring_sweep" in e.get("name", "")]
        print(f"profiler_trace {name} ranges {len(ranges)} (host "
              f"{len(host)}) ring_sweep kernels {len(kernels)} over "
              f"{STEPS} replayed steps, {len(evs)} trace events")
        check(host, f"profiler_trace: the trace holds {name}")
        check(kernels, "profiler_trace: the trace holds K1's ring_sweep")
        start = min(float(e["ts"]) for e in host)
        check(all(float(e["ts"]) >= start for e in kernels),
              "profiler_trace: every ring_sweep lies inside the run's "
              "window")
        ring_check(s, s._host_step)
        count.report("profiler_trace", "ring_reduce", launches, s._host_step)
    finally:
        shutil.rmtree(directory, ignore_errors=True)


def observed_paths(launches: dict) -> None:
    """ring_metrics, region_observed and profiler_trace."""
    for label, phase in (("ring_metrics", ring_metrics),
                         ("region_observed", region_observed),
                         ("profiler_trace", profiler_trace)):
        t0 = time.perf_counter()
        phase(launches)
        print(f"{label} phase_s {time.perf_counter() - t0}")
        free()


# ------------------------------------------------------------ actor paths
ACTOR_N = N - 256           # the actor ring's block; promise rows follow
ASK_ACTORS, ASK_CONC, ASK_ROUNDS = 4096, 256, 32  # actor_ask's trace
ASK_SLOTS = 4               # actor_ask's mailbox slots (bounded: K2)
# actor_ask's dispatcher, which the staging legs and typed_persistence
# share: 2^20 rows, bounded slots (K2), depth 4, 256 promise rows
ASK_DISPATCHER = {"type": "tpu-batched", "capacity": N,
                  "payload-width": PAYLOAD_W, "mailbox-slots": ASK_SLOTS,
                  "spill-capacity": 0, "promise-rows": 256,
                  "host-inbox": 4096, "pipeline-depth": 4}
BLAT_ROUNDS = 200           # rounds per leg of the bridge-latency pair
ACTOR_TIMEOUT = 30.0        # every ask, result() and probe wait
ADD, GET = 0, 1


@behavior("counter", {"count": ((), torch.float32)}, inbox="slots")
def slots_counter(state, mailbox, ctx):
    """tests/test_bridge.py's counter: ADD adds payload[0], GET replies
    the count after the step's messages to the reply row."""
    def apply(carry, t, pl):
        cnt, rdst = carry
        return (torch.where(t == ADD, cnt + pl[:, 0], cnt),
                torch.where(t == GET, reply_dst(pl), rdst))

    n = ctx.actor_id.shape[0]
    cnt, rdst = mailbox.fold(
        (state["count"], torch.full((n,), -1, dtype=torch.int32,
                                    device=ctx.actor_id.device)), apply)
    reply = torch.zeros((n, PAYLOAD_W), device=ctx.actor_id.device)
    reply[:, 0] = cnt
    return ({"count": cnt},
            Emit.single(rdst, reply, 1, PAYLOAD_W, when=rdst >= 0))


def system_inputs(s):
    """A BatchedSystem's delivery inputs as its next step will read them
    (the carried inbox, cloned), and its recipient count."""
    return (s.inbox_dst.clone(), s.inbox_type.clone(),
            s.inbox_payload.clone(), s.inbox_valid.clone()), s.capacity


class StepProbe:
    """For one stretch of a path, wraps `method` of a system: by default a
    BatchedSystem's `_advance` (the graph replay of each step); for a
    sharded system `_flush_staged`, with which each of its runs starts.
    CUDA events around each call, whose times sum to the stretch's
    device-busy time in its steps, and, with `live`, after each call a
    count of the carried inbox's valid rows (a sync a call) and a clone of
    the fullest inbox (`inputs` of the system), the delivery input of the
    step after it."""

    def __init__(self, rt, live: bool = False, method: str = "_advance",
                 inputs=system_inputs):
        self.rt, self.live, self.method, self.of = rt, live, method, inputs
        self.events, self.rows, self.inputs = [], 0, None
        self.busy_ms = 0.0

    def __enter__(self):
        rt, call = self.rt, getattr(self.rt, self.method)

        def probed(*args) -> None:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            call(*args)
            end.record()
            self.events.append((start, end))
            if self.live:
                rows = int(rt.inbox_valid.sum())
                if rows > self.rows:
                    self.rows, self.inputs = rows, self.of(rt)

        setattr(rt, self.method, probed)
        return self

    def __exit__(self, *exc) -> None:
        delattr(self.rt, self.method)
        torch.cuda.synchronize()
        self.busy_ms = sum(s.elapsed_time(e) for s, e in self.events)


def handle_window(h, fn):
    """fn() between two readings of the handle's step counter and the
    launch counts, each under the handle's step lock, so that a step of
    its pump thread falls wholly inside or outside the window. Returns
    (fn's result, steps taken, the window's Launches)."""
    out, steps, count = handles_window([h], fn)
    return out, steps[0], count


def handles_window(hs, fn):
    """handle_window over several handles: the readings are taken under
    all their step locks. Returns (fn's result, steps by handle, the
    window's Launches)."""
    count = Launches()

    def locked(read):
        for h in hs:
            h._step_lock.acquire()
        try:
            return read()
        finally:
            for h in reversed(hs):
                h._step_lock.release()

    def start():
        cm.reset_launches()
        return [h._runtime._host_step for h in hs]

    steps0 = locked(start)
    out = fn()

    def end():
        for k, v in cm.LAUNCHES.items():
            count.counts[k] += v
        return [h._runtime._host_step - s for h, s in zip(hs, steps0)]

    return out, locked(end), count


def pcts_us(xs) -> dict:
    return {"p50_us": float(np.percentile(xs, 50) * 1e6),
            "p99_us": float(np.percentile(xs, 99) * 1e6)}


def actor_ring(system, launches: dict, flat: dict) -> None:
    """A ring of ACTOR_N device actors spawned through
    system.actor_of(device_props(...)) on the tpu-dispatcher (capacity
    2^20, 256 promise rows after the block), seeded with one token a row
    by one DeviceBlockRef.tell, then handle.step(STEPS) as graph replays,
    PAIRS times on CUDA events; every actor must hold one token per step
    taken (the pump may take the seed's step), and K1 must launch once a
    step. Each timed h.step(STEPS) is paired with a run(STEPS) of the
    handle's own BatchedSystem under its step lock (the same inbox, no
    handle), which splits the gap to the bare ring_reduce cell into the
    handle's work a step and the larger inbox."""
    ring_n = make_block_ring_behavior(ACTOR_N)
    block = system.actor_of(device_props(ring_n, n=ACTOR_N), "ring")
    check(isinstance(block, DeviceBlockRef) and len(block) == ACTOR_N,
          "actor_ring: a DeviceBlockRef of the block")
    h = get_handle(system)
    t0 = time.perf_counter()
    rt = h.runtime  # built: the spawn replayed, the step captured
    print(f"actor_ring warmup_s {time.perf_counter() - t0} staging "
          f"{'native' if rt.native_staging else 'list'}")
    times, bare = [], []

    def drive():
        t0 = time.perf_counter()
        block.tell((0, [1.0, 0.0, 0.0, 0.0]))
        h.step(1)
        print(f"actor_ring seed_s {time.perf_counter() - t0} (one tell of "
              f"{ACTOR_N} rows, staged and flushed)")
        for _ in range(PAIRS):
            times.append(bm.cuda_ms(lambda: h.step(STEPS), iters=1,
                                    warmup=0) / STEPS)
            with h._step_lock:
                bare.append(bm.cuda_ms(lambda: h._runtime.run(STEPS),
                                       iters=1, warmup=0) / STEPS)

    _, steps, count = handle_window(h, drive)
    rt = h.runtime
    ms, run_ms = float(np.median(times)), float(np.median(bare))
    print(f"actor_ring graph ms_per_step {ms} runs {times} "
          f"system_run_ms_per_step {run_ms} runs {bare} "
          f"ring_reduce_ms_per_step {GRAPH_MS.get('ring_reduce')} "
          f"(inbox {rt.inbox_dst.shape[0]} rows against {M})")
    print(f"actor_ring msgs_per_s {ACTOR_N / (ms * 1e-3)}")
    print(f"actor_ring pipeline {h.pipeline_stats()}")
    received = block.read_state("received")
    check(np.array_equal(received, np.full(ACTOR_N, steps, np.int32)),
          f"actor_ring: every actor received one token per step ({steps})")
    check(not h.read_state(h.PROMISE_REPLIED).any(),
          "actor_ring: no promise row latched")
    graph_line("actor_ring", rt)
    count.report("actor_ring", "ring_reduce", launches, steps)
    flat["actor_ring"] = ("K1", system_inputs(rt), SLOTS)


def bridge_latency(h, row: int) -> dict:
    """The reference's bridge-latency pair (bench.py
    bench_bridge_latency) on a handle before its pump starts: the sync
    round (a step, a full synchronise and the promise-block readback,
    with one never-resolving waiter outstanding) against the depth-k
    round (enqueue + the oldest attention word), BLAT_ROUNDS of each,
    then the best steps/s of three windows of each."""
    with h._lock:
        slot = h._promise_free.pop()
        prow = h._promise_base + slot
    h._clear_latches([slot])
    with h._lock:
        h._waiters[prow] = (Future(), h.default_codec)
        h._waiter_deadlines[prow] = (time.monotonic() + 3600.0, 3600.0)

    def old_round():
        with h._step_lock:
            h._runtime.step()
        h._runtime.block_until_ready()
        h._resolve_waiters()

    dq: deque = deque()

    def new_round():
        h._enqueue_step(dq)
        h._drain_one(dq)

    def rounds(fn):
        fn()
        fn()
        ts = []
        for _ in range(BLAT_ROUNDS):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        return ts

    def best_rate(window):
        best = 0.0
        for _ in range(3):
            t0 = time.perf_counter()
            window(BLAT_ROUNDS)
            best = max(best, BLAT_ROUNDS / (time.perf_counter() - t0))
        return best

    old_ts, new_ts = rounds(old_round), rounds(new_round)
    sync_rate = best_rate(lambda k: [old_round() for _ in range(k)])
    pipe_rate = best_rate(lambda k: h.step(k, depth=4))
    with h._lock:  # retire the synthetic waiter
        h._waiters.pop(prow, None)
        h._waiter_deadlines.pop(prow, None)
        h._promise_free.append(slot)
    out = {"rounds": BLAT_ROUNDS, "depth": 4,
           "sync": {"dispatch": pcts_us(old_ts), "steps_per_sec": sync_rate},
           "pipelined": {"dispatch": pcts_us(new_ts),
                         "steps_per_sec": pipe_rate}}
    out["dispatch_speedup_p50"] = out["sync"]["dispatch"]["p50_us"] / \
        out["pipelined"]["dispatch"]["p50_us"]
    out["overlap_speedup"] = pipe_rate / sync_rate
    return out


def actor_ask(system, launches: dict, flat: dict) -> None:
    """ASK_ACTORS counter actors on a second tpu-batched dispatcher of the
    same system (capacity 2^20, ASK_SLOTS bounded slots: K2), first the
    bridge-latency pair (pump-free), then ASK_ROUNDS rounds of ASK_CONC
    concurrent ref.ask()s through the pump thread, each after a tell of
    an add to the same actor, with CUDA events around each step's replay
    (the rounds' device-busy share); every reply must equal the host
    oracle's running total, and K2 must launch once a step. One more
    round, untimed, takes K2's delivery input from the step that leaves
    the most messages in the carried inbox."""
    did = "akka.actor.ask-dispatcher"
    block = system.actor_of(device_props(slots_counter, n=ASK_ACTORS,
                                         dispatcher=did), "counters")
    refs = [block[i] for i in range(ASK_ACTORS)]
    h = get_handle(system, did)
    t0 = time.perf_counter()
    rt = h.runtime
    print(f"actor_ask warmup_s {time.perf_counter() - t0} staging "
          f"{'native' if rt.native_staging else 'list'}")
    check(rt.spill_cap == 0 and rt.mailbox_slots == ASK_SLOTS,
          "actor_ask: bounded slots mailboxes")
    rng = np.random.default_rng(5)
    oracle = np.zeros(ASK_ACTORS)
    lat, bad = [], []

    def ask_round(lat_out):
        pick = rng.choice(ASK_ACTORS, ASK_CONC, replace=False)
        vals = rng.integers(1, 100, ASK_CONC).astype(np.float64)
        futs = []
        for i, v in zip(pick, vals):
            oracle[i] += v
            refs[i].tell((ADD, [v]))
            t_ask = time.perf_counter()
            f = refs[i].ask((GET, [0.0]), timeout=ACTOR_TIMEOUT)
            f.add_done_callback(
                lambda _f, t=t_ask: lat_out.append(time.perf_counter() - t))
            futs.append((i, f))
        for i, f in futs:
            got = f.result(ACTOR_TIMEOUT)
            if got[0] != oracle[i]:
                bad.append((int(i), float(got[0]), oracle[i]))

    def drive():
        st0 = h.pipeline_stats()
        blat = bridge_latency(h, refs[0].row)
        print(f"actor_ask bridge_latency {json.dumps(blat)}")
        st1 = h.pipeline_stats()
        with StepProbe(h.runtime) as probe:
            t0 = time.perf_counter()
            for _ in range(ASK_ROUNDS):
                ask_round(lat)
            wall = time.perf_counter() - t0
        st2 = h.pipeline_stats()
        with StepProbe(h.runtime, live=True) as live:
            ask_round([])
        return wall, (st0, st1, st2), probe, live

    (wall, (st0, st1, st2), probe, live), steps, count = handle_window(
        h, drive)
    check(not bad, f"actor_ask: replies equal the oracle ({bad[:4]})")
    check(len(lat) == ASK_ROUNDS * ASK_CONC, "actor_ask: every ask resolved")
    keys = ("steps", "drains", "wide_resolves", "host_checks")
    blat_d = {k: st1[k] - st0[k] for k in keys}
    rounds_d = {k: st2[k] - st1[k] for k in keys}
    print(f"actor_ask asks_per_s {ASK_ROUNDS * ASK_CONC / wall} "
          f"ask {json.dumps(pcts_us(lat))}")
    print(f"actor_ask pipeline_stats {h.pipeline_stats()} bridge_latency "
          f"{blat_d} rounds {rounds_d} steps_per_round "
          f"{rounds_d['steps'] / ASK_ROUNDS}")
    replays = len(probe.events)
    print(f"actor_ask rounds replays {replays} wall_ms {wall * 1e3} busy_ms {probe.busy_ms} "
          f"busy_share {probe.busy_ms / (wall * 1e3)} busy_ms_per_step "
          f"{probe.busy_ms / replays} wall_ms_per_step "
          f"{wall * 1e3 / replays} (CUDA events around each replay)")
    pool = h.ask_pool_stats()
    print(f"actor_ask ask_pool_stats {pool}")
    check(pool["in_flight"] == 0, "actor_ask: no ask left in flight")
    counts = block.read_state("count")
    check(np.array_equal(counts, oracle.astype(np.float32)),
          "actor_ask: every counter equals the oracle")
    inputs, n = live.inputs if live.inputs is not None else (None, 0)
    check(live.rows > 0 and int(inputs[3].sum()) > 0,
          f"actor_ask: K2's input carries messages ({live.rows} rows)")
    print(f"actor_ask kernel_input live_rows {live.rows} of "
          f"{inputs[0].shape[0]} (the fullest inbox of "
          f"{len(live.events)} steps)")
    graph_line("actor_ask", h.runtime)
    count.report("actor_ask", "ring_slots", launches, steps)
    flat["actor_ask"] = ("K2", (inputs, n), ASK_SLOTS)


@behavior("fragile", {"n": ((), torch.int32), "_failed": ((), torch.bool)})
def fragile(state, inbox, ctx):
    """Counts its messages; a negative payload[0] raises its error lane."""
    poison = (inbox.count > 0) & (inbox.sum[:, 0] < 0)
    return ({"n": state["n"] + inbox.count,
             "_failed": state["_failed"] | poison},
            Emit.none(ctx.actor_id.shape[0], 1, PAYLOAD_W,
                      device=ctx.actor_id.device))


@behavior("late", {"seen": ((), torch.float32)})
def late(state, inbox, ctx):
    """A behavior type spawned after the build (a rebuild)."""
    return ({"seen": state["seen"] + inbox.sum[:, 0]},
            Emit.none(ctx.actor_id.shape[0], 1, PAYLOAD_W,
                      device=ctx.actor_id.device))


@behavior("echo", {})
def echo2(state, inbox, ctx):
    """Replies twice the request's payload to the reply row."""
    return state, Emit.single(reply_dst(inbox.sum), inbox.sum * 2, 1,
                              PAYLOAD_W, when=inbox.count > 0,
                              dtype=inbox.sum.dtype)


def actor_lifecycle(launches: dict, flat: dict) -> None:
    """A system whose default dispatcher is tpu-batched: a host Echo actor
    beside device actors; a watched device actor stopped (Terminated to a
    TestProbe, a late tell to DeadLetter); a poisoned row under
    failure_policy restart (DeviceActorFailed, back to its spawn-time
    init); a new behavior type spawned with asks in flight (a rebuild:
    every reply and the state held to the oracle, the captures printed);
    then a bf16 handle at capacity 256 answering an ask (bf16 K1)."""
    cfg = {"akka": {"stdout-loglevel": "OFF", "log-dead-letters": 0,
                    "actor": {"default-dispatcher": {
                        "type": "tpu-batched", "capacity": 4096,
                        "payload-width": PAYLOAD_W, "mailbox-slots": 0,
                        "promise-rows": 64, "host-inbox": 256,
                        "failure-policy": "restart"}}}}
    system = ActorSystem.create("actor-lifecycle", cfg)
    count = Launches()
    try:
        host = system.actor_of(Props.create(Echo), "host-echo")
        probe = TestProbe(system)
        host.tell("hi", probe.ref)
        check(probe.receive_one(ACTOR_TIMEOUT) == "hi",
              "actor_lifecycle: the host actor answers")
        # reduce-mode counters: one ask per counter and step (a reduce
        # inbox sums the reply ids of asks that land together)
        counters = system.actor_of(device_props(
            counter_behavior(PAYLOAD_W), n=8), "counters")
        counter = counters[0]
        frag = system.actor_of(device_props(fragile, n=8, init_state={
            "n": np.int32(5)}), "fragile")
        mortal = system.actor_of(device_props(late), "mortal")
        h = get_handle(system)
        t0 = time.perf_counter()
        rt = h.runtime
        print(f"actor_lifecycle warmup_s {time.perf_counter() - t0}")

        def leg():
            total = 0.0
            for v in (3.0, 4.0):
                total += v
                got = counter.ask_sync([v], timeout=ACTOR_TIMEOUT)
                check(got[0] == total, f"actor_lifecycle: ask {got[0]} == "
                      f"{total}")
            # deathwatch and dead letters
            probe.watch(mortal)
            dl = TestProbe(system)
            system.event_stream.subscribe(dl.ref, DeadLetter)
            mortal.stop()
            term = probe.expect_terminated(mortal, ACTOR_TIMEOUT)
            check(term.actor is mortal, "actor_lifecycle: Terminated")
            mortal.tell([1.0])
            check(isinstance(dl.receive_one(ACTOR_TIMEOUT), DeadLetter),
                  "actor_lifecycle: a late tell is a DeadLetter")
            # the error lane under failure_policy restart
            failed = TestProbe(system)
            system.event_stream.subscribe(failed.ref, DeviceActorFailed)
            frag.tell([1.0])
            h.step(1)
            frag[0].tell([-1.0])
            ev = failed.receive_one(ACTOR_TIMEOUT)
            check(list(ev.rows) == [int(frag.rows[0])] and
                  ev.action == "restart", f"actor_lifecycle: {ev}")
            h.step(1)
            n = frag.read_state("n")
            check(n.tolist() == [5] + [6] * 7, f"actor_lifecycle: the "
                  f"restarted row is back at its init ({n.tolist()})")
            # a rebuild with asks in flight, one to each other counter
            before = h.runtime._graphs.stats()
            vals = [1.0, 2.0, 5.0, 7.0, 11.0, 13.0, 17.0]
            futs = [counters[i + 1].ask([v], timeout=ACTOR_TIMEOUT)
                    for i, v in enumerate(vals)]
            fresh = system.actor_of(device_props(echo2), "late-echo")
            after = h.runtime._graphs.stats()
            print(f"actor_lifecycle rebuild captures before {before} "
                  f"after {after}")
            check(h.runtime is not rt, "actor_lifecycle: rebuilt")
            got = [float(f.result(ACTOR_TIMEOUT)[0]) for f in futs]
            check(got == vals, f"actor_lifecycle: replies across the "
                  f"rebuild {got}")
            check(frag.read_state("n").tolist() == n.tolist(),
                  "actor_lifecycle: state kept across the rebuild")
            got = fresh.ask_sync([21.0], timeout=ACTOR_TIMEOUT)
            check(got[0] == 42.0, "actor_lifecycle: the new behavior "
                  "answers")
            check(counters.read_state("total").tolist() == [total] + vals,
                  "actor_lifecycle: the counters' totals")

        count(leg)
        graph_line("actor_lifecycle", h.runtime)
        count.report("actor_lifecycle", "ring_reduce", launches)
    finally:
        system.terminate()
        check(system.await_termination(ACTOR_TIMEOUT),
              "actor_lifecycle: the system terminated")
    # a bf16 handle within its exact reply ids
    # (host_inbox 1024: an inbox of more than SCATTER_MAX_M rows, which
    # the ring kernel delivers; a smaller one is scattered)
    bf = BatchedRuntimeHandle(capacity=256, payload_width=PAYLOAD_W,
                              payload_dtype=torch.bfloat16, promise_rows=8,
                              host_inbox=1024)
    try:
        row = int(bf.spawn(echo2, 1)[0])
        bf.runtime

        def ask():
            with StepProbe(bf.runtime, live=True) as live:
                got = bf.ask_sync(row, (0, [3.0, 0, 0, 0]),
                                  timeout=ACTOR_TIMEOUT)
            return got, live

        (got, live), steps, count = handle_window(bf, ask)
        check(float(got[0]) == 6.0, f"actor_lifecycle_bf16: reply {got}")
        check(bf.runtime.inbox_payload.dtype == torch.bfloat16,
              "actor_lifecycle_bf16: bf16 payloads")
        check(live.rows > 0, "actor_lifecycle_bf16: K1's input carries "
              "the reply")
        print(f"actor_lifecycle_bf16 kernel_input live_rows {live.rows} of "
              f"{live.inputs[0][0].shape[0]}")
        count.report("actor_lifecycle_bf16", "ring_reduce", launches, steps)
        flat["actor_lifecycle_bf16"] = ("K1", live.inputs, SLOTS)
    finally:
        bf.shutdown()


class Echo(Actor):
    def receive(self, message):
        self.sender.tell(message, self.self_ref)


def actor_paths(launches: dict) -> dict:
    """actor_ring and actor_ask in one ActorSystem (two tpu-batched
    dispatchers), then actor_lifecycle; returns each path's delivery
    inputs as (kernel, (inputs, n), slots) by label."""
    cfg = {"akka": {"stdout-loglevel": "OFF", "log-dead-letters": 0,
                    "actor": {
                        "tpu-dispatcher": {
                            "capacity": N, "payload-width": PAYLOAD_W,
                            "mailbox-slots": 0, "promise-rows": 256,
                            "host-inbox": ACTOR_N},
                        "ask-dispatcher": dict(ASK_DISPATCHER)}}}
    flat: dict = {}
    system = ActorSystem.create("actor-paths", cfg)
    try:
        for label, phase in (("actor_ring", actor_ring),
                             ("actor_ask", actor_ask)):
            t0 = time.perf_counter()
            phase(system, launches, flat)
            print(f"{label} phase_s {time.perf_counter() - t0}")
    finally:
        system.terminate()
        check(system.await_termination(ACTOR_TIMEOUT),
              "actor_paths: the system terminated")
    del system
    free()
    t0 = time.perf_counter()
    actor_lifecycle(launches, flat)
    print(f"actor_lifecycle phase_s {time.perf_counter() - t0}")
    free()
    return flat


# ------------------------------------------- BASELINE configs 4 and 1
ROUTER_PRODUCERS, ROUTEES = 1 << 20, 100_000   # bench config 4
PP_ROUNDS = 2000            # ping_pong latency rounds a leg and pair
PIPE_CHUNKS, PIPE_LEN = 64, 1 << 20   # device_pipeline: 256 MiB float32


def staged_probe(rt) -> dict:
    """Wrap a BatchedSystem's drain for the rest of its life: the most rows
    its staging buffer (native stager or Python list) held before a
    flush, and the drains that found any."""
    seen = {"max_staged": 0, "drains": 0}
    drain = rt._drain_to_pad

    def probed() -> int:
        n = len(rt._staging)
        seen["max_staged"] = max(seen["max_staged"], n)
        seen["drains"] += n > 0
        return drain()

    rt._drain_to_pad = probed
    return seen


def staging_check(label: str, rt, native: bool, seen: dict) -> None:
    """A staging leg took the path it asked for, staged through it, and
    dropped nothing."""
    check(rt.native_staging is native, f"{label}: native_staging {native}")
    check(seen["max_staged"] > 0, f"{label}: tells staged through the "
          f"{'stager' if native else 'list'} before a flush")
    check(rt.dropped_messages == 0, f"{label}: no tell dropped")
    print(f"{label} staging {'native' if native else 'list'} max_staged "
          f"{seen['max_staged']} drains {seen['drains']} dropped "
          f"{rt.dropped_messages}")


def baseline_paths(launches: dict) -> dict:
    """BASELINE configs 4 and 1 (bench.py:145-165, :226-294). router and
    router_api: 2^20 producers round-robin over 100k routees, every
    producer telling every step, as step cells (graph against eager
    twin); every routee hit closes to (steps - 1) * producers (deliveries
    lag a step), the two builders' hits bit-equal, K1 once a step.
    ping_pong: the latency loop, with the native stager and the Python
    list in interleaved pairs. Returns K1's delivery input of the router
    (its carried inbox after the cells)."""
    hits = {}

    def router_check(label):
        def check_fn(s, steps):
            h = s.read_state("hits")[:ROUTEES]
            want = (steps - 1) * ROUTER_PRODUCERS
            check(int(h.astype(np.int64).sum()) == want,
                  f"{label}: hits sum {int(h.sum())} == {want}")
            check(int(h.max() - h.min()) <= steps - 1,
                  f"{label}: round robin spreads evenly")
            hits[label] = h
        return check_fn

    flat = {}
    for label, build in (("router", build_router),
                         ("router_api", build_router_api)):
        g, _ = step_cell(label, "ring_reduce", lambda: build(
            ROUTER_PRODUCERS, ROUTEES, device="cuda"), launches,
            router_check(label), ROUTER_PRODUCERS, seed=lambda s: None)
        if label == "router":
            inputs, n = system_inputs(g)
            live = int(inputs[3].sum())
            print(f"router kernel_input live_rows {live} of "
                  f"{inputs[0].shape[0]} recipients {n} routees {ROUTEES} "
                  f"msgs_per_routee {live / ROUTEES}")
            check(live == ROUTER_PRODUCERS, "router: K1's input holds "
                  "one message per producer")
            flat["K1"] = (inputs, n)
        del g
        free()
    check(np.array_equal(hits["router"], hits["router_api"]),
          "router_api: hits bit-equal to router's")
    ping_pong(launches)
    free()
    return flat


def ping_pong(launches: dict) -> None:
    """bench.py bench_latency on the card, for each staging leg (native
    stager, Python list) in PAIRS interleaved pairs: PP_ROUNDS rounds of
    tell -> step() -> sync, split into tell, dispatch and block (p50/p99),
    then PP_ROUNDS steps of step() + sync against run_pipelined(depth=2)
    (steps/s). hits[0] + hits[1] must equal a host replay of the
    two-actor exchange (tests/test_baseline_benches.py:49)."""
    legs = {}
    for native in (True, False):
        s = build_ping_pong(device="cuda", native_staging=native)
        s.warmup()
        legs[native] = {"s": s, "seen": staged_probe(s),
                        "inbox": [0, 0], "hits": 0, "count": Launches(),
                        "round": [], "tell": [], "dispatch": [],
                        "block": [], "sync": [], "depth2": []}

    def host_step(leg, told: int) -> None:
        """The exchange on the host: leg["inbox"][a] messages reach actor
        a at the next step (each actor forwards one message, the sum of
        what it got, to the other); `told` host tells to actor 0 join."""
        m0, m1 = leg["inbox"][0] + told, leg["inbox"][1]
        leg["hits"] += m0 + m1
        leg["inbox"] = [1 if m1 else 0, 1 if m0 else 0]

    for leg in legs.values():  # bench.py's warm-up: a tell, two steps
        s = leg["s"]
        s.tell(0, [1.0, 0, 0, 0])
        s.step()
        s.step()
        s.block_until_ready()
        host_step(leg, 1)
        host_step(leg, 0)

    for _ in range(PAIRS):
        for native, leg in legs.items():
            s = leg["s"]

            def rounds():
                for _ in range(PP_ROUNDS):
                    t0 = time.perf_counter()
                    s.tell(0, [1.0, 0, 0, 0])
                    t1 = time.perf_counter()
                    s.step()
                    t2 = time.perf_counter()
                    s.block_until_ready()
                    t3 = time.perf_counter()
                    leg["round"].append(t3 - t0)
                    leg["tell"].append(t1 - t0)
                    leg["dispatch"].append(t2 - t1)
                    leg["block"].append(t3 - t2)
                    host_step(leg, 1)

                t0 = time.perf_counter()
                for _ in range(PP_ROUNDS):
                    s.step()
                    s.block_until_ready()
                    host_step(leg, 0)
                leg["sync"].append(PP_ROUNDS / (time.perf_counter() - t0))
                t0 = time.perf_counter()
                s.run_pipelined(PP_ROUNDS, depth=2)
                s.block_until_ready()
                for _ in range(PP_ROUNDS):
                    host_step(leg, 0)
                leg["depth2"].append(PP_ROUNDS / (time.perf_counter() - t0))

            leg["count"](rounds)
    for native, leg in legs.items():
        s, name = leg["s"], f"ping_pong_{'native' if native else 'list'}"
        h = s.read_state("hits")
        check(int(h[0]) + int(h[1]) == leg["hits"],
              f"{name}: hits {int(h[0]) + int(h[1])} == {leg['hits']}")
        staging_check(name, s, native, leg["seen"])
        out = {k: pcts_us(leg[k])
               for k in ("round", "tell", "dispatch", "block")}
        print(f"{name} rounds {PAIRS * PP_ROUNDS} {json.dumps(out)}")
        print(f"{name} steps_per_s sync {leg['sync']} depth2 "
              f"{leg['depth2']} overlap_speedup "
              f"{float(np.median(leg['depth2']) / np.median(leg['sync']))}")
        # two actors deliver by scatter (M <= SCATTER_MAX_M): no ring kernel
        leg["count"].report(name, None, launches)


def pipe_chain(device: str = "cuda") -> DevicePipeline:
    """device_pipeline's chain: map -> filter -> map -> scan, the scan
    carrying the kept-lane count and the running max."""
    return (DevicePipeline(device=device)
            .map(lambda x: x * 3.0 - 1.0)
            .filter(lambda x: x > 0.5)
            .map(lambda x: x * 0.5)
            .scan(lambda c, x: ((c[0] + (x != 0).sum(),
                                 torch.maximum(c[1], x.max())),
                                x + c[0].to(torch.float32)),
                  (torch.tensor(0, dtype=torch.int32),
                   torch.tensor(0.0))))


def pipe_chunks(device: str = "cuda") -> torch.Tensor:
    """device_pipeline's input: PIPE_CHUNKS stacked chunks of PIPE_LEN
    float32 normals (seed 7)."""
    gen = torch.Generator(device=device).manual_seed(7)
    return torch.randn((PIPE_CHUNKS, PIPE_LEN), generator=gen,
                       device=device)


def pipeline_paths(launches: dict) -> None:
    """device_pipeline: map -> filter -> map -> scan over PIPE_CHUNKS
    stacked chunks of PIPE_LEN float32 on the card, as CUDA-graph replays
    (one capture) against the same chain run eagerly, PAIRS interleaved
    pairs: outputs, masks and the carry bit-equal, and compact() equal to
    a numpy oracle of the chain. Prints ms per chunk for both."""
    chunks = pipe_chunks()
    g, e = pipe_chain(), pipe_chain()
    e._eager = True
    count = Launches()
    t0 = time.perf_counter()
    count(lambda: g.run(chunks[:2]))  # the capture
    print(f"device_pipeline capture_s {time.perf_counter() - t0} captures "
          f"{g.compile().captures}")
    times = {"graph": [], "eager": []}
    res = {}
    for _ in range(PAIRS):
        for mode, p in (("graph", g), ("eager", e)):
            def one(p=p, mode=mode):
                res[mode] = p.run(chunks)
            ms = bm.cuda_ms(one, iters=1, warmup=0) if mode == "eager" \
                else count(lambda: bm.cuda_ms(one, iters=1, warmup=0))
            times[mode].append(ms / PIPE_CHUNKS)
    for mode, ts in times.items():
        print(f"device_pipeline {mode} ms_per_chunk "
              f"{float(np.median(ts))} pairs {ts}")
    (go, gm, (gc_, gx)), (eo, em, (ec, ex)) = res["graph"], res["eager"]
    check(torch.equal(go, eo) and torch.equal(gm, em),
          "device_pipeline: graph outputs and masks bit-equal to eager")
    check(int(gc_) == int(ec) and torch.equal(gx, ex),
          "device_pipeline: graph carry bit-equal to eager")
    x = chunks.cpu().numpy()
    count_ = np.int64(0)
    want = []
    for c in x:
        y = c * np.float32(3.0) - np.float32(1.0)
        keep = y > np.float32(0.5)
        y = np.where(keep, y, np.float32(0)) * np.float32(0.5)
        want.append((y + np.float32(count_))[keep])
        count_ += int((y != 0).sum())
    want = np.concatenate(want)
    got = DevicePipeline.compact(go, gm)
    check(got.dtype == np.float32 and np.array_equal(got, want),
          f"device_pipeline: compact equals the numpy oracle "
          f"({got.shape[0]} lanes)")
    check(int(gc_) == int(count_), "device_pipeline: carry count")
    print(f"device_pipeline kept {got.shape[0]} of {x.size} carry "
          f"({int(gc_)}, {float(gx)}) memory_reserved "
          f"{torch.cuda.memory_reserved()}")
    count.report("device_pipeline", None, launches)
    del g, e, chunks, res
    free()


STAGE_ROUNDS = 8            # ask rounds a staging leg and pair
TELL_ROUNDS = 200           # tell_step rounds a staging leg and pair


def staging_paths(launches: dict) -> None:
    """The native stager against the Python list on the paths that stage
    host tells, in PAIRS interleaved pairs a path: actor_ask's rounds
    (two tpu-batched dispatchers of one system, their handles built
    with native_staging true and false, ASK_ACTORS counters each,
    STAGE_ROUNDS rounds of ASK_CONC tell + ref.ask pairs a leg) and the ring's tell_step (2^20 actors,
    TELL_ROUNDS rounds of three tells, step() and a sync). Each leg
    prints tell p50/p99 and asks/s (steps/s for the ring), must hold its
    oracle, stage through its buffer and drop nothing; K2 (K1) once a
    step."""
    cfg = {"akka": {"stdout-loglevel": "OFF", "log-dead-letters": 0,
                    "actor": {"ask-native": dict(ASK_DISPATCHER),
                              "ask-list": dict(ASK_DISPATCHER)}}}
    system = ActorSystem.create("staging-paths", cfg)
    try:
        legs = {}
        rng = np.random.default_rng(6)
        for native in (True, False):
            did = f"akka.actor.ask-{'native' if native else 'list'}"
            # the handle is built here, with its staging path, before the
            # first actor_of would build it with the default
            h = system.dispatchers.lookup(did).handle(
                system, native_staging=native)
            block = system.actor_of(device_props(
                slots_counter, n=ASK_ACTORS, dispatcher=did),
                f"counters-{native}")
            check(get_handle(system, did) is h,
                  f"ask-{native}: actor_of used the built handle")
            legs[native] = {"h": h, "refs": [block[i]
                                             for i in range(ASK_ACTORS)],
                            "block": block, "oracle": np.zeros(ASK_ACTORS),
                            "seen": staged_probe(h.runtime), "tell": [],
                            "ask": [], "rate": [], "steps": 0,
                            "count": Launches(), "bad": []}

        def ask_round(leg):
            pick = rng.choice(ASK_ACTORS, ASK_CONC, replace=False)
            vals = rng.integers(1, 100, ASK_CONC).astype(np.float64)
            futs = []
            for i, v in zip(pick, vals):
                leg["oracle"][i] += v
                t0 = time.perf_counter()
                leg["refs"][i].tell((ADD, [v]))
                t1 = time.perf_counter()
                f = leg["refs"][i].ask((GET, [0.0]), timeout=ACTOR_TIMEOUT)
                f.add_done_callback(lambda _f, t=t1: leg["ask"].append(
                    time.perf_counter() - t))
                leg["tell"].append(t1 - t0)
                futs.append((i, f))
            for i, f in futs:
                got = f.result(ACTOR_TIMEOUT)
                if got[0] != leg["oracle"][i]:
                    leg["bad"].append((int(i), float(got[0])))

        for _ in range(PAIRS):
            for native, leg in legs.items():
                def rounds(leg=leg):
                    t0 = time.perf_counter()
                    for _ in range(STAGE_ROUNDS):
                        ask_round(leg)
                    return time.perf_counter() - t0
                wall, steps, count = handle_window(leg["h"], rounds)
                leg["rate"].append(STAGE_ROUNDS * ASK_CONC / wall)
                leg["steps"] += steps
                for k, v in count.counts.items():
                    leg["count"].counts[k] += v
        for native, leg in legs.items():
            name = f"actor_ask_{'native' if native else 'list'}"
            h, rt = leg["h"], leg["h"].runtime
            check(not leg["bad"], f"{name}: replies equal the oracle "
                  f"({leg['bad'][:4]})")
            check(np.array_equal(leg["block"].read_state("count"),
                                 leg["oracle"].astype(np.float32)),
                  f"{name}: every counter equals the oracle")
            check(h.ask_pool_stats()["in_flight"] == 0,
                  f"{name}: no ask left in flight")
            staging_check(name, rt, native, leg["seen"])
            print(f"{name} asks_per_s {leg['rate']} median "
                  f"{float(np.median(leg['rate']))} tell "
                  f"{json.dumps(pcts_us(leg['tell']))} ask "
                  f"{json.dumps(pcts_us(leg['ask']))}")
            leg["count"].report(name, "ring_slots", launches, leg["steps"])
    finally:
        system.terminate()
        check(system.await_termination(ACTOR_TIMEOUT),
              "staging_paths: the system terminated")
    del system, legs
    free()

    rings = {}
    told = [0, 5, 7]
    for native in (True, False):
        s = build_ring(N, static=False, device="cuda", native_staging=native)
        seed_ring_full(s)
        s.warmup()
        rings[native] = {"s": s, "seen": staged_probe(s), "tell": [],
                         "rate": [], "count": Launches(),
                         "extra": np.zeros(N, np.int64)}
    for _ in range(PAIRS):
        for native, leg in rings.items():
            s = leg["s"]

            def rounds():
                t0 = time.perf_counter()
                for _ in range(TELL_ROUNDS):
                    t1 = time.perf_counter()
                    s.tell(told, [1.0, 0.0, 0.0, 0.0])
                    leg["tell"].append(time.perf_counter() - t1)
                    s.step()
                    s.block_until_ready()
                return time.perf_counter() - t0
            wall = leg["count"](rounds)
            leg["rate"].append(TELL_ROUNDS / wall)
            leg["extra"][told] += TELL_ROUNDS
    for native, leg in rings.items():
        s, name = leg["s"], f"tell_step_{'native' if native else 'list'}"
        steps = s._host_step
        got = s.read_state("received").astype(np.int64)
        check(np.array_equal(got, steps + leg["extra"]),
              f"{name}: every actor one token a step, told rows one more "
              f"a tell")
        staging_check(name, s, native, leg["seen"])
        print(f"{name} steps_per_s {leg['rate']} median "
              f"{float(np.median(leg['rate']))} tell "
              f"{json.dumps(pcts_us(leg['tell']))}")
        leg["count"].report(name, "ring_reduce", launches,
                            PAIRS * TELL_ROUNDS)
    del rings
    free()


# ---------------------------------------------------------- failover paths
FO_CAP = 1_048_560          # the largest multiple of 24 <= 2^20: divides
                            # 1, 2, 3, 4 and 8 shards
FO_SLOTS = 4                # sentinel_failover's starting mesh
FO_SEED, FO_RATE = 7, 0.01  # DeviceLossInjector: shard 3 lost at step 42
FO_HORIZON = 56             # steps of the failover leg
FO_DT = 0.1                 # manual detection clock seconds per step
FO_PROMISE, FO_ECHO = 256, 4096  # promise rows, then the asks' targets
FO_WALK = (2, 4, 8, 4)      # sentinel_reshard's widths
FO_ASKS = 256               # asks in flight across each re-shard
FO_TELLS = 4                # tells into the ring every 4th step
FO_COLLECTORS = 1000        # autoscale: the fan-in's hot recipients
REGION_FO_WAVES = (16, 8, 16)  # waves before the checkpoint, after it,
                               # and after the failover


def fo_ring(base: int, n: int):
    """The ring over rows [base, base + n): each forwards its token to the
    next row of the block, counting tokens (`received`) and summing
    their column 0 (`total`)."""

    @behavior("fo_ring", {"received": ((), torch.int32),
                          "total": ((), torch.float32)})
    def ring(state, inbox, ctx):
        nxt = base + (ctx.actor_id - base + 1) % n
        return ({"received": state["received"] + inbox.count,
                 "total": state["total"] + inbox.sum[:, 0]},
                Emit.single(nxt, inbox.sum, 1, PAYLOAD_W,
                            when=inbox.count > 0))

    return ring


@behavior("fo_echo", {"seen": ((), torch.float32)})
def fo_echo(state, inbox, ctx):
    """Replies twice the request's column 0 to its reply row."""
    body = torch.zeros_like(inbox.sum)
    body[:, 0] = inbox.sum[:, 0] * 2.0
    return ({"seen": state["seen"] + inbox.sum[:, 0]},
            Emit.single(reply_dst(inbox.sum), body, 1, PAYLOAD_W,
                        when=inbox.count > 0))


def seed_ring_rows(sys_, base: int, values: torch.Tensor) -> None:
    """One token [v, 0, 0, 0] per ring row, written straight into each
    shard's self-chunk of the exchange region (seed_sharded_ring's
    layout), so the first step delivers all of them."""
    dev = sys_.device
    ids = torch.arange(base, sys_.capacity, dtype=torch.int64, device=dev)
    shard, r = ids // sys_.local_n, ids % sys_.local_n
    idx = shard * sys_.m_local + sys_.spill_cap + shard * sys_.pair_cap + r
    sys_.inbox_dst[idx] = ids.to(torch.int32)
    sys_.inbox_payload[idx] = 0.0
    sys_.inbox_payload[idx, 0] = values.to(dev)
    sys_.inbox_valid[idx] = True


def fo_sentinel(directory: str, fr, **kw):
    """The failover legs' MeshSentinel: promise rows, the echo block and
    the ring over the rest, at FO_CAP rows on FO_SLOTS slots of the card,
    snapshots every 8 steps and the WAL (group commit of 256 records);
    the ring seeded on every row with integer values 1..9."""
    from akka_tpu_torch.batched import MeshSentinel
    ring_base = FO_PROMISE + FO_ECHO
    ring = fo_ring(ring_base, FO_CAP - ring_base)
    clk = {"t": 0.0}
    sent = MeshSentinel(
        FO_CAP, [ring, fo_echo], checkpoint_dir=directory,
        n_devices=FO_SLOTS, payload_width=PAYLOAD_W,
        checkpoint_interval_steps=8, pipeline_depth=2,
        wal_fsync_every_n=256, promise_rows=FO_PROMISE,
        detector_threshold=3.0, heartbeat_interval=FO_DT,
        acceptable_pause=3 * FO_DT, failover_min_backoff=0.35,
        clock=lambda: clk["t"], flight_recorder=fr, **kw)
    check(sent.capacity == FO_CAP, "sentinel capacity kept")
    sent.spawn(1, FO_ECHO)
    sent.spawn(0, FO_CAP - ring_base)
    gen = torch.Generator().manual_seed(FO_SEED)
    values = torch.randint(1, 10, (FO_CAP - ring_base,),
                           generator=gen).float()
    seed_ring_rows(sent.system, ring_base, values)
    return sent, clk, ring_base, values


def fo_schedule(ring_base: int) -> dict:
    """FO_TELLS tells into the ring every 4th step, values 1..9."""
    rng = np.random.default_rng(FO_SEED)
    return {s: [(int(d), float(v)) for d, v in zip(
        rng.integers(ring_base, FO_CAP, FO_TELLS),
        rng.integers(1, 10, FO_TELLS))] for s in range(0, FO_HORIZON, 4)}


def sentinel_failover(directory: str, launches: dict) -> tuple:
    """sentinel_failover: the sentinel at FO_CAP rows on 4 slots under a
    DeviceLossInjector that loses slot 3 at step 42 fails over to 3
    slots on its own and runs on to FO_HORIZON; held to an uninterrupted
    twin (the same system on 4 slots, the same tells at the same steps):
    every integer bit-equal, the sums within rtol/atol. Prints MTTR, the
    rebuild's parts and bench.py's manual-restore baseline (a fresh
    system on the survivors restoring the latest snapshot + WAL and
    stepping once) with mttr_over_restore. Returns the sentinel, its
    clock and the ring's first row."""
    from akka_tpu_torch.persistence.slab_snapshot import latest_slab_path
    from akka_tpu_torch.testkit.chaos import DeviceLossInjector
    fr = InMemoryFlightRecorder()
    inj = DeviceLossInjector(FO_SEED, FO_SLOTS, loss_rate=FO_RATE)
    check(inj.lost_at(FO_SLOTS - 1, FO_HORIZON) == 42 and all(
        inj.lost_at(s, FO_HORIZON) is None for s in range(FO_SLOTS - 1)),
        "sentinel_failover: one loss scheduled, slot 3 at step 42")
    sent, clk, ring_base, values = fo_sentinel(directory, fr, injector=inj)
    twin = sent._build_system(sent.devices)  # the same rows, no journal
    twin.tell_journal = twin.flight_recorder = None
    seed_ring_rows(twin, ring_base, values)
    sched = fo_schedule(ring_base)
    count = Launches()
    staged = set()
    t0 = time.perf_counter()

    def drive():
        while sent.host_step < FO_HORIZON:
            hs = sent.host_step
            if hs in sched and hs not in staged:
                for d, v in sched[hs]:
                    sent.tell(d, [v, 0.0, 0.0, 0.0])
                staged.add(hs)
            clk["t"] += FO_DT
            sent.step(1)
    count(drive)
    drive_s = time.perf_counter() - t0
    count.report("sentinel_failover", "ring_reduce", launches)
    st = sent.failover_stats
    check(len(st) == 1 and st[0]["lost_shards"] == [FO_SLOTS - 1] and
          st[0]["detector"] == "phi-accrual" and sent.halted is None,
          f"sentinel_failover: one automatic failover of slot 3 ({st})")
    check(sent.system.n_shards == FO_SLOTS - 1, "sentinel_failover: 3 "
          "slots after the failover")
    check(st[0]["mttr_s"] is not None, "sentinel_failover: MTTR closed")
    for hs in range(FO_HORIZON):
        for d, v in sched.get(hs, ()):
            twin.tell(d, [v, 0.0, 0.0, 0.0])
        twin.run(1)
    for col in ("received", "total"):
        got = torch.from_numpy(sent.read_state(col))
        want = torch.from_numpy(twin.read_state(col))
        if col == "received":
            check(torch.equal(got, want), "sentinel_failover: received "
                  "bit-equal to the uninterrupted twin")
        else:
            torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    rows = slice(ring_base, FO_CAP)
    received = sent.read_state("received")[rows]
    check(int(received.min()) >= FO_HORIZON, "sentinel_failover: every "
          "ring row received a token a step")
    events = [e["event"] for e in fr.events()]
    for ev in ("device_suspected", "device_evicted", "failover_completed"):
        check(events.count(ev) == 1, f"sentinel_failover: one {ev}")
    rt = sent.rebuild_timings
    graphs_st = sent.system._graphs.stats()
    print(f"sentinel_failover rows {FO_CAP} evicted_at_step "
          f"{st[0]['evicted_at_step']} restored_step "
          f"{st[0]['restored_step']} mttr_s {st[0]['mttr_s']} rebuild_s "
          f"{st[0]['rebuild_s']} load_ms {rt['load_ms']} build_ms "
          f"{rt['build_ms']} restore_ms {rt['restore_ms']} replay_ms "
          f"{rt['replay_ms']} replayed_steps {rt['replayed_steps']} "
          f"capture_ms {rt['capture_ms']} (graph capture_ms "
          f"{graphs_st['capture_ms']} warmup_ms {graphs_st['warm_ms']}) "
          f"drive_s {drive_s}")
    # bench.py's manual-restore baseline on the same survivors
    snap = latest_slab_path(directory)
    t0 = time.perf_counter()
    manual = sent._build_system(sent.devices)
    manual.tell_journal = manual.flight_recorder = None
    manual.restore(snap, journal=sent._journal)
    manual.run(1)
    manual.block_until_ready()
    restore_s = time.perf_counter() - t0
    print(f"sentinel_failover manual_restore_s {restore_s} "
          f"mttr_over_restore {st[0]['mttr_s'] / restore_s}")
    graph_line("sentinel_failover", sent.system)
    flat = {"K1": flat_inputs(sent.system)}
    del twin, manual
    free()
    return sent, clk, ring_base, flat


def sentinel_reshard(sent, clk, ring_base: int, launches: dict) -> None:
    """sentinel_reshard: the failed-over sentinel walks scale_to through
    FO_WALK (3 -> 2 -> 4 -> 8 -> 4 slots), each transition with FO_ASKS
    asks in flight (half delivered with their replies on the way, half
    staged); every ask resolves with twice its value, and the ring's
    tokens are conserved (its received counts grow by the token count a
    step). Prints each pause_s and the memory allocated and reserved at
    the first 4-slot mesh and at the last: the old systems' graphs and
    pools are released."""
    count = Launches()
    echo = np.arange(FO_PROMISE, FO_PROMISE + FO_ECHO)
    # every ring row receives its predecessor's token each step (a tell
    # merged into the token it met), so one message a ring row a step
    n_tokens = FO_CAP - ring_base
    rng = np.random.default_rng(3)
    mem = {}

    def walk():
        for w in FO_WALK:
            before = int(sent.read_state("received").astype(np.int64).sum())
            step0 = sent.host_step
            futs = []
            for half in range(2):
                for i in rng.choice(echo, FO_ASKS // 2, replace=False):
                    v = float(rng.integers(1, 100))
                    futs.append((v, sent.ask(int(i), [v, 0.0, 0.0],
                                             timeout=1e9)))
                if half == 0:
                    clk["t"] += FO_DT
                    sent.step(1)  # delivered: replies on the way
            clk["t"] += 1.0  # past the anti-thrash window (0.35 s)
            rec = sent.scale_to(_slots(w), trigger="chip_smoke")
            for _ in range(8):
                if all(f.done() for _, f in futs):
                    break
                clk["t"] += FO_DT
                sent.step(1)
            for v, f in futs:
                check(float(f.result(ACTOR_TIMEOUT)[0]) == 2 * v,
                      "sentinel_reshard: every ask's reply == 2 x value")
            after = int(sent.read_state("received").astype(np.int64).sum())
            check(after - before == n_tokens * (sent.host_step - step0),
                  f"sentinel_reshard: ring tokens conserved across "
                  f"{rec['from_shards']} -> {rec['to_shards']}")
            check(sent.system.n_shards == w, f"sentinel_reshard: {w} slots")
            rt = sent.rebuild_timings
            print(f"sentinel_reshard {rec['from_shards']}->"
                  f"{rec['to_shards']} pause_s {rec['pause_s']} "
                  f"restore_ms {rt['restore_ms']} replay_ms "
                  f"{rt['replay_ms']} capture_ms {rt['capture_ms']} "
                  f"asks {len(futs)}")
            if w == 4:
                free()
                torch.cuda.synchronize()
                mem.setdefault("first", (torch.cuda.memory_allocated(),
                                         torch.cuda.memory_reserved()))
                mem["last"] = (torch.cuda.memory_allocated(),
                               torch.cuda.memory_reserved())
    count(walk)
    count.report("sentinel_reshard", "ring_reduce", launches)
    (a0, r0), (a1, r1) = mem["first"], mem["last"]
    print(f"sentinel_reshard memory_allocated first_4 {a0} last_4 {a1} "
          f"memory_reserved first_4 {r0} last_4 {r1}")
    check(a1 <= a0 * 1.1 + (64 << 20), "sentinel_reshard: the old systems' "
          "graphs and pools were released")
    st = sent.sentinel_stats()
    check(st["reshards"] == len(FO_WALK), "sentinel_reshard: every walk")
    graph_line("sentinel_reshard", sent.system)


def _slots(n: int) -> list:
    """The first n shard slots of the card."""
    from akka_tpu_torch.parallel import shard_slots
    return shard_slots(max(8, n), "cuda")[:n]


@behavior("as_leaf", {"sent": ((), torch.int32)}, always_on=True)
def as_leaf(state, inbox, ctx):
    """Sends [1, 0, 0, 0] to collector id % FO_COLLECTORS every step."""
    return ({"sent": state["sent"] + 1},
            Emit.single(ctx.actor_id % FO_COLLECTORS, [1.0], 1, PAYLOAD_W))


@behavior("as_collector", {"got": ((), torch.int32)}, inbox="slots")
def as_collector(state, mailbox, ctx):
    """Counts the messages its bounded mailbox kept."""
    got = mailbox.fold(torch.zeros_like(state["got"]),
                       lambda c, t, p: c + 1)
    return ({"got": state["got"] + got},
            Emit.none(got.shape[0], 1, PAYLOAD_W, device=got.device))


def autoscale_leg(directory: str, launches: dict) -> dict:
    """autoscale: a sentinel at FO_CAP rows on 2 slots with bounded
    2-slot mailboxes (spill_capacity=0: K2) where every leaf sends to one
    of 1000 collectors every step, so the collectors' mailboxes overflow
    by ~1M messages a step; an attached MeshAutoscaler (the default pool
    of 8 slots on the card) must widen it to 4 slots on the
    mailbox_overflow signal. Prints the decision record."""
    from akka_tpu_torch.batched import (AutoscalePolicy, MeshAutoscaler,
                                        MeshSentinel)
    fr = InMemoryFlightRecorder()
    sent = MeshSentinel(FO_CAP, [as_leaf, as_collector],
                        checkpoint_dir=directory, n_devices=2,
                        payload_width=PAYLOAD_W, mailbox_slots=SLOTS,
                        spill_capacity=0, checkpoint_interval_steps=0,
                        failover_min_backoff=0.0, flight_recorder=fr)
    sent.spawn(1, FO_COLLECTORS)
    sent.spawn(0, FO_CAP - FO_COLLECTORS)
    auto = MeshAutoscaler(sent, AutoscalePolicy(
        min_shards=2, max_shards=4, widen_after=2, narrow_after=1 << 20,
        cooldown_polls=1))
    check(auto.device_pool == _slots(8), "autoscale: the default pool is "
          "8 slots on the card")
    sent.attach_autoscaler(auto)
    count = Launches()

    def drive():
        for _ in range(8):
            sent.step(1)
            if len(sent.devices) == 4:
                return
    count(drive)
    count.report("autoscale", "ring_slots", launches)
    dec = fr.of_type("autoscale_decision")
    check(len(sent.devices) == 4 and dec and dec[0]["direction"] == "widen"
          and dec[0]["signal"] == "mailbox_overflow",
          f"autoscale: widened 2 -> 4 on mailbox_overflow ({dec})")
    print(f"autoscale decision {json.dumps(auto.last)} stats "
          f"{json.dumps(auto.stats())}")
    sent.step(1)
    got = sent.read_state("got")[:FO_COLLECTORS]
    check(int(got.min()) >= 1 and int(got.max()) <= SLOTS * sent.host_step,
          "autoscale: the collectors kept at most their slots a step")
    flat = {"K2": flat_inputs(sent.system)}
    sent.shutdown()
    return flat


def region_failover(label: str, slots: int, kernel: str, directory: str,
                    launches: dict) -> dict:
    """region_failover(_slots): region_serve's region at n_devices=2 with
    the tell WAL and the entity journal: REGION_FO_WAVES[0] ask waves, a
    checkpoint, REGION_FO_WAVES[1] more (a WAL tail), failover to the
    mesh's first slot, REGION_FO_WAVES[2] more; every reply equals the
    host oracle's running total, and so does every total after it."""
    region = DeviceShardRegion(DeviceEntity(
        "counter", counter_behavior(PAYLOAD_W), n_shards=256,
        entities_per_shard=4096, n_devices=2, spare_blocks=2,
        mailbox_slots=slots, spill_capacity=0 if slots else None),
        device="cuda")
    region.system.warmup()
    region.attach_journal(directory)
    region.attach_entity_journal(directory)
    a, b, c = REGION_FO_WAVES
    trace = make_trace(2, a + b + c)
    oracle = {}
    count = Launches()
    timing = {}

    def leg():
        ask_waves(region, trace[:a], oracle, label)
        region.checkpoint()
        ask_waves(region, trace[a:a + b], oracle, label)
        t0 = time.perf_counter()
        timing["step"] = region.failover(list(region.system.mesh.slots[:1]))
        timing["failover_ms"] = (time.perf_counter() - t0) * 1e3
        timing["acked"] = dict(region._durable_replayed_totals)
        ask_waves(region, trace[a + b:], oracle, label)
    count(leg)
    count.report(label, kernel, launches)
    check(region.system.n_shards == 1 and region.n_devices == 1,
          f"{label}: one slot after the failover")
    names = sorted(oracle)
    got = region.system.read_state(
        "total", np.asarray([region.entity_ref(n).row for n in names]))
    check(all(float(g) == oracle[n] for g, n in zip(got, names)),
          f"{label}: every total == the host oracle's")
    check(region.ask_pool_stats()["in_flight"] == 0,
          f"{label}: no ask left in flight")
    t = region.restore_timings
    print(f"{label} failover_ms {timing['failover_ms']} step "
          f"{timing['step']} load_ms {t['load_ms']} h2d_ms {t['h2d_ms']} "
          f"replay_ms {t['replay_ms']} replayed_steps "
          f"{t['replayed_steps']} acked_entities {len(timing['acked'])}")
    graph_line(label, region.system)
    sys_ = region.system
    for i in range(WAVE_ASKS):  # a wave's tells as they land
        sys_.tell(i * 4099 % sys_.capacity,
                  [1.0, 0.0, 0.0, float(sys_.capacity - 1)])
    sys_._flush_staged()
    return {"K2" if slots else "K1": flat_inputs(sys_)}


def failover_paths(launches: dict) -> dict:
    """sentinel_failover and sentinel_reshard (one sentinel), autoscale,
    region_failover and region_failover_slots, each in a checkpoint
    directory of its own; returns each leg's fullest delivery inputs by
    kernel."""
    flats = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_",
                                     ignore_cleanup_errors=True) as d:
        t0 = time.perf_counter()
        sent, clk, ring_base, flats["sentinel_failover"] = \
            sentinel_failover(d, launches)
        print(f"sentinel_failover phase_s {time.perf_counter() - t0}")
        t0 = time.perf_counter()
        sentinel_reshard(sent, clk, ring_base, launches)
        flats["sentinel_reshard"] = {"K1": flat_inputs(sent.system)}
        sent.shutdown()
        del sent
        free()
        print(f"sentinel_reshard phase_s {time.perf_counter() - t0}")
    legs = (("autoscale", autoscale_leg),
            ("region_failover", lambda d, n: region_failover(
                "region_failover", 0, "ring_reduce", d, n)),
            ("region_failover_slots", lambda d, n: region_failover(
                "region_failover_slots", SLOTS, "ring_slots", d, n)))
    for label, leg in legs:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_",
                                         ignore_cleanup_errors=True) as d:
            t0 = time.perf_counter()
            flats[label] = leg(d, launches)
            free()
            print(f"{label} phase_s {time.perf_counter() - t0}")
    return flats


# ------------------------------------------------------------------ ranks
RANK_GLOO_STEPS = 10        # rank_gloo_ring's steps (the exchange may
                            # cross the host every step)
RANK_WAVES = (16, 8)        # rank_region's waves before the checkpoint,
                            # and after the restore
RANK_TIMEOUT_S = 60.0       # the gloo store's and groups' timeout


def free_port() -> int:
    """A free TCP port on 127.0.0.1 (the coordinator's)."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def gloo_ranks(world: int, fn, tag: str) -> list:
    """fn(rank, group) on `world` gloo ranks as threads of this process
    (one HashStore, a ProcessGroupGloo each; RANK_TIMEOUT_S timeouts):
    each rank's result in rank order; the first rank's error re-raised;
    every thread joined and none left alive."""
    store = dist.HashStore()
    store.set_timeout(datetime.timedelta(seconds=RANK_TIMEOUT_S))
    out, errors = [None] * world, [None] * world

    def body(r):
        try:
            group = dist.ProcessGroupGloo(
                dist.PrefixStore(tag, store), r, world,
                datetime.timedelta(seconds=RANK_TIMEOUT_S))
            out[r] = fn(r, group)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors[r] = e

    threads = [threading.Thread(target=body, args=(r,), daemon=True,
                                name=f"gloo-{tag}-{r}")
               for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10 * RANK_TIMEOUT_S)
    check(not any(t.is_alive() for t in threads), f"{tag}: every gloo "
          f"rank thread ended")
    for e in errors:
        if e is not None:
            raise e
    return out


def collective_share(label: str, g, e, steps: int, count) -> None:
    """`steps` steps of the ranked system `g` and of its one-card twin
    `e`, each under torch.profiler: the card's time by kernel (and copy)
    name, and what the ranked step spends beyond its twin, name by name
    (the collective and the permuted copy that replaces the transpose),
    as a share of its busy time; NCCL's kernels by name."""
    def by_name(fn):
        with ps.traced() as prof:
            fn()
        out: Dict[str, float] = {}
        for ev in ps.device_events(prof.key_averages()):
            out[ev.key] = out.get(ev.key, 0.0) + ps.device_us(ev)
        return out

    ranked = by_name(lambda: count(lambda: g.run(steps)))
    one = by_name(lambda: e.run(steps))
    busy = sum(ranked.values())
    extra = {k: v - one.get(k, 0.0) for k, v in ranked.items()
             if v - one.get(k, 0.0) > 0.01 * busy}
    nccl = {k: v for k, v in ranked.items() if "nccl" in k.lower()}
    print(f"{label} profiled {steps} steps: device_busy_ms_per_step ranked "
          f"{busy / 1e3 / steps} one_card {sum(one.values()) / 1e3 / steps}"
          f"; ranked beyond its twin, ms per step: "
          f"{ {k: v / 1e3 / steps for k, v in extra.items()} } share "
          f"{sum(extra.values()) / busy if busy else None}; nccl kernels "
          f"ms per step { {k: v / 1e3 / steps for k, v in nccl.items()} }")
    top = sorted(ranked.items(), key=lambda kv: -kv[1])[:8]
    print(f"{label} ranked top kernels ms per step "
          f"{[(k[:60], v / 1e3 / steps) for k, v in top]}")


def rank_ring(label: str, kernel: str, build, group, launches: dict,
              check_fn) -> dict:
    """The cross-shard ring at full width on a ranked mesh of 8 slots over
    the NCCL group, with graphs (the collectives captured), against its
    one-card twin (cross_shard_d8's system, graphs too): a first run of
    STEPS, PAIRS interleaved timed runs (ranked, one card), a profiled
    run (the collective's share), the closed form, the carries (integers
    bit-equal, floats within RTOL/ATOL) and K1/K2 once per step."""
    g = build(make_mesh(8, group=group))
    e = build(None)
    check(g.mesh.world_size == 1 and g.ranks.backend == "nccl" and
          not g._eager, f"{label}: a ranked system stepping on graphs")
    for s in (g, e):
        seed_ring_full(s)
    t0 = time.perf_counter()
    g.warmup()
    print(f"{label} warmup_s {time.perf_counter() - t0}")
    e.warmup()
    count = Launches()
    count(lambda: g.run(STEPS))
    e.run(STEPS)
    times = {"ranked": [], "one_card": []}
    for _ in range(PAIRS):
        times["ranked"].append(count(lambda: bm.cuda_ms(
            lambda: g.run(STEPS), iters=1, warmup=0)) / STEPS)
        times["one_card"].append(bm.cuda_ms(lambda: e.run(STEPS), iters=1,
                                            warmup=0) / STEPS)
    for mode, ts in times.items():
        print(f"{label} {mode} ms_per_step {float(np.median(ts))} "
              f"pairs {ts}")
    print(f"{label} ranked_over_one_card "
          f"{np.median(times['ranked']) / np.median(times['one_card'])}")
    collective_share(label, g, e, PROFILE_STEPS, count)
    torch.cuda.synchronize()
    check_fn(g, g._host_step)
    check_twin(label, g, e, "one-card twin")
    graph_line(label, g)
    check(g._graphs.stats()["captures"] >= 1, f"{label}: the step and its "
          f"all_to_all_single captured")
    count.report(label, kernel, launches, g._host_step)
    flat = {"K2" if kernel == "ring_slots" else "K1": flat_inputs(g)}
    del g, e
    free()
    return flat


def rank_gloo_ring(launches: dict) -> dict:
    """rank_gloo_ring: the full-width cross-shard ring on two gloo ranks
    (threads of this process) of 4 slots each, every rank's tensors on
    the card, eager steps, RANK_GLOO_STEPS steps; every rank's global
    carry held to the one-card twin's. Prints whether gloo took the CUDA
    tensors or the port staged them through pinned host memory."""
    label = "rank_gloo_ring"
    twin = build_cross_shard(256, 4096, n_devices=8, device="cuda")
    seed_ring_full(twin)
    twin.warmup()
    twin.run(RANK_GLOO_STEPS)
    want = numpy_carry(twin)
    del twin
    free()

    def rank(r, group):
        mesh = make_mesh(8, device="cuda:0", group=group)
        s = build_cross_shard(256, 4096, n_devices=8, mesh=mesh)
        check(s._eager and s.local_shards == 4, f"{label}: rank {r} steps "
              f"eagerly over its 4 shards")
        seed_ring_full(s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.run(RANK_GLOO_STEPS)
        s.block_until_ready()
        ms = (time.perf_counter() - t0) * 1e3 / RANK_GLOO_STEPS
        carry = numpy_carry(s)
        return ms, carry, flat_inputs(s)

    count = Launches()
    outs = count(lambda: gloo_ranks(2, rank, label))
    print(f"{label}: a gloo group cannot be captured, so its steps are "
          f"eager; gloo took the CUDA tensors as they are (the port "
          f"stages nothing through host memory)")
    for r, (ms, carry, _) in enumerate(outs):
        print(f"{label} rank {r} ms_per_step {ms} (host clock, eager)")
        check(sorted(carry) == sorted(want), f"{label}: the carry's fields")
        for k, a in want.items():
            if a.dtype.kind == "f":
                check(np.allclose(carry[k], a, rtol=RTOL, atol=ATOL),
                      f"{label} rank {r} vs one-card twin: {k}")
            else:
                check(np.array_equal(carry[k], a),
                      f"{label} rank {r} vs one-card twin: {k} bit-equal")
    check((outs[0][1]["state/received"] == RANK_GLOO_STEPS).all(),
          f"{label}: every entity received one token per step")
    counts = count.counts
    print(f"{label} launches {counts} (2 ranks x {RANK_GLOO_STEPS} steps)")
    check(counts["ring_reduce"] >= RANK_GLOO_STEPS, f"{label}: K1 launched "
          f"on every rank's step")
    launches[label] = dict(counts)
    flat = {"K1": outs[0][2]}
    del outs
    free()
    return flat


def region_spec(n_devices: int) -> DeviceEntity:
    return DeviceEntity("counter", counter_behavior(PAYLOAD_W), n_shards=256,
                        entities_per_shard=4096, n_devices=n_devices,
                        spare_blocks=2)


def rank_region(label: str, mesh, trace, directory: str, count) -> dict:
    """region_serve's region on `mesh` (every rank calls this alike):
    RANK_WAVES[0] ask waves, a checkpoint, a restore into a fresh region
    on the same directory, RANK_WAVES[1] waves; every reply and every
    total equal to the host oracle. Returns the fresh system's delivery
    inputs as a wave's tells land."""
    a, b = RANK_WAVES
    region = DeviceShardRegion(region_spec(mesh.size), mesh=mesh)
    region.system.warmup()
    region.attach_journal(directory)
    region.attach_entity_journal(directory)
    oracle = {}
    t0 = time.perf_counter()
    count(lambda: ask_waves(region, trace[:a], oracle, label))
    asks_s = a * WAVE_ASKS / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    region.checkpoint()
    ckpt_ms = (time.perf_counter() - t0) * 1e3
    del region
    fresh = DeviceShardRegion(region_spec(mesh.size), mesh=mesh)
    fresh.system.warmup()
    fresh.attach_journal(directory)
    fresh.attach_entity_journal(directory)
    t0 = time.perf_counter()
    step = count(fresh.restore)
    restore_ms = (time.perf_counter() - t0) * 1e3
    count(lambda: ask_waves(fresh, trace[a:a + b], oracle, label))
    names = sorted(oracle)
    got = fresh.system.read_state(
        "total", np.asarray([fresh.entity_ref(n).row for n in names]))
    check(all(float(g) == oracle[n] for g, n in zip(got, names)),
          f"{label}: every total == the host oracle's")
    check(fresh.ask_pool_stats()["in_flight"] == 0,
          f"{label}: no ask left in flight")
    sys_ = fresh.system
    print(f"{label} rank {mesh.rank}/{mesh.world_size} slots "
          f"{sys_.local_shards} rows {sys_.n_rows} of {sys_.capacity} "
          f"asks_per_s {asks_s} (host clock, {a} waves) checkpoint_ms "
          f"{ckpt_ms} restore_ms {restore_ms} step {step} entities "
          f"{len(names)} eager {sys_._eager}")
    for i in range(WAVE_ASKS):  # a wave's tells as they land
        sys_.tell(i * 4099 % sys_.capacity,
                  [1.0, 0.0, 0.0, float(sys_.capacity - 1)])
    sys_._flush_staged()
    return {"K1": flat_inputs(sys_)}


def rank_banks(label: str, mesh, replicas: int) -> None:
    """converge_over_mesh of a 2^20-key uint32 max bank and an "or" set
    over the mesh's ranks, held to the one-card amax (any) of the whole
    stack; every rank builds the stack from one seed and keeps its
    replicas."""
    per = replicas // mesh.world_size
    lo = mesh.rank * per
    gen = torch.Generator(device="cuda").manual_seed(18)
    stack = torch.randint(0, 2 ** 32, (replicas, 1 << 20, 8),
                          generator=gen, device="cuda")
    gmax = stack.to(torch.int32).view(torch.uint32)
    gset = torch.randint(0, 8, (replicas, 1 << 20, 4), generator=gen,
                         device="cuda") == 0
    one = make_mesh(replicas, axis_name="replica")
    for name, bank, op in (("gcounter", gmax, "max"), ("gset", gset, "or")):
        want = ddt.converge_over_mesh(bank, one, op=op)[lo:lo + per]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = ddt.converge_over_mesh(bank[lo:lo + per].clone(), mesh, op=op)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        check(got.dtype == bank.dtype and torch.equal(
            got.view(torch.int32) if op == "max" else got,
            want.view(torch.int32) if op == "max" else want),
            f"{label}: {name} converged == the one-card join")
        print(f"{label} rank {mesh.rank} {name} {tuple(got.shape)} "
              f"{got.dtype} ms {ms} (host clock)")


def rank_actor_system() -> None:
    """rank_actor_system: an ActorSystem started with
    akka.jax-distributed.enabled initializes its own NCCL group of world
    size 1 (an all_reduce over it and a host ask go through), and
    terminate() destroys it."""
    label = "rank_actor_system"
    check(not dist.is_initialized(), f"{label}: no group before it")
    system = ActorSystem.create("rank-actors", {"akka": {"jax-distributed": {
        "enabled": True, "coordinator-address": f"127.0.0.1:{free_port()}",
        "num-processes": 1, "process-id": 0}}})
    try:
        check(dist.is_initialized() and dist.get_backend() == "nccl",
              f"{label}: the system started an NCCL group")
        t = torch.arange(4, dtype=torch.int32, device="cuda")
        make_mesh(1, group=process_group()).ranks.all_reduce(t, "max")
        check(t.tolist() == [0, 1, 2, 3], f"{label}: an all_reduce over it")
        echo = system.actor_of(Props.create(Echo))
        check(ask_sync(echo, "hi", 10.0, system) == "hi",
              f"{label}: a host ask")
    finally:
        system.terminate()
        check(system.await_termination(10.0), f"{label}: terminated")
    check(not dist.is_initialized(), f"{label}: terminate() destroyed the "
          f"group")
    print(f"{label} ok: started and destroyed its own NCCL group")


def rank_paths(launches: dict) -> dict:
    """The ranks phase (ROADMAP A10.2). On an NCCL group of world size 1
    (initialize_distributed on 127.0.0.1): rank_nccl_ring and
    rank_nccl_slots (the full-width cross-shard ring and its bounded
    slots twin on a ranked mesh of 8 slots, graphs with the collective
    captured, against cross_shard_d8's one-card twins), rank_region_nccl
    (2 slots) and rank_banks_nccl. Then two gloo ranks as threads, every
    rank's tensors on the card: rank_gloo_ring, rank_region_gloo (1 slot
    each) and rank_banks_gloo. Every group is torn down in a finally;
    then rank_actor_system. Returns each leg's fullest rank-local
    delivery inputs by kernel."""
    flats = {}
    trace = make_trace(3, sum(RANK_WAVES))
    try:
        check(initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0),
              "rank: this call started the NCCL group")
        group = process_group()
        t0 = time.perf_counter()
        flats["rank_nccl_ring"] = rank_ring(
            "rank_nccl_ring", "ring_reduce",
            lambda mesh: build_cross_shard(256, 4096, n_devices=8,
                                           mesh=mesh, device="cuda"),
            group, launches, cross_shard_ring_check("rank_nccl_ring", 8))
        print(f"rank_nccl_ring phase_s {time.perf_counter() - t0}")
        t0 = time.perf_counter()

        def slots_check(r, steps):
            check((r.read_state("received") == steps).all(),
                  "rank_nccl_slots: every entity received one token a step")
            check(r.total_dropped == 0 and r.mailbox_overflow == 0,
                  "rank_nccl_slots: nothing dropped")

        flats["rank_nccl_slots"] = rank_ring(
            "rank_nccl_slots", "ring_slots",
            lambda mesh: build_cross_shard_slots(
                256, 4096, n_devices=8, slots=SLOTS, mesh=mesh,
                device="cuda"), group, launches, slots_check)
        print(f"rank_nccl_slots phase_s {time.perf_counter() - t0}")
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_",
                                         ignore_cleanup_errors=True) as d:
            count = Launches()
            flats["rank_region_nccl"] = rank_region(
                "rank_region_nccl", make_mesh(2, group=group), trace, d,
                count)
            count.report("rank_region_nccl", "ring_reduce", launches)
        free()
        rank_banks("rank_banks_nccl", make_mesh(2, axis_name="replica",
                                                group=group), 2)
        print(f"rank_region_nccl + banks phase_s {time.perf_counter() - t0}")

        t0 = time.perf_counter()
        flats["rank_gloo_ring"] = rank_gloo_ring(launches)
        print(f"rank_gloo_ring phase_s {time.perf_counter() - t0}")
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_",
                                         ignore_cleanup_errors=True) as d:
            count = Launches()

            def region_rank(r, g):
                out = rank_region("rank_region_gloo",
                                  make_mesh(2, device="cuda:0", group=g),
                                  trace, d, lambda fn: fn())
                rank_banks("rank_banks_gloo", make_mesh(
                    2, axis_name="replica", device="cuda:0", group=g), 2)
                return out

            outs = count(lambda: gloo_ranks(2, region_rank,
                                            "rank_region_gloo"))
            count.report("rank_region_gloo", "ring_reduce", launches)
            flats["rank_region_gloo"] = outs[0]
        free()
        print(f"rank_region_gloo + banks phase_s {time.perf_counter() - t0}")
    finally:
        shutdown_distributed()
    t0 = time.perf_counter()
    rank_actor_system()
    print(f"rank_actor_system phase_s {time.perf_counter() - t0}")
    return flats


# --------------------------------------- typed persistence (ROADMAP A12.1)
TP_COUNTERS, TP_LEDGERS = 4096, 64    # device counters, event-sourced ledgers
TP_ROUNDS, TP_CONC = 16, 256          # rounds of concurrent commands, seed 5
TP_SNAPSHOT_EVERY = 64                # RetentionCriteria.snapshot_every_n
TP_BACKOFF = 0.25                     # the supervised ledger's min backoff
TP_PHASE_S = 60.0                     # the phase's limit
TP_DISPATCHER = "akka.actor.ledger-dispatcher"
TP_KEY = ServiceKey("ledgers")


@dataclasses.dataclass(frozen=True)
class LedgerAdd:
    """Add `value` to device counter `counter`; the reply is ("ok", the
    counter's total after it, the event's sequence number)."""
    counter: int
    value: float
    reply_to: object


@dataclasses.dataclass(frozen=True)
class CounterReplied:
    """A device counter's reply to a ledger's ask, piped to the ledger."""
    cmd: LedgerAdd
    total: float
    error: str


@dataclasses.dataclass(frozen=True)
class LedgerState:
    reply_to: object


@dataclasses.dataclass(frozen=True)
class Poison:
    pass


@dataclasses.dataclass(frozen=True)
class GetRefs:
    reply_to: object


def ledger_event(state, event):
    """A ledger's state: (events, sum of added values, sum of the totals
    the counters replied), all plain Python numbers."""
    _k, v, total = event
    return (state[0] + 1, state[1] + v, state[2] + total)


def ledger(i: int, counters, recovery: dict):
    """Ledger i: an EventSourcedBehavior (PersistenceId Ledger|i, a
    snapshot every TP_SNAPSHOT_EVERY events) that registers with the
    Receptionist under TP_KEY. A LedgerAdd tells the add to its device
    counter and asks the counter (ctx.ask, piped to itself); on the
    reply it persists (counter, value, total) and then replies. Its
    registration's ack is its first message, which starts its recovery:
    recovery[i] holds (spawn time, recovery-completed time)."""
    def setup(ctx):
        t0 = time.perf_counter()
        Receptionist.get(ctx.system).register(TP_KEY, ctx.self,
                                              reply_to=ctx.self)

        def on_command(state, cmd):
            if isinstance(cmd, LedgerAdd):
                ref = counters[cmd.counter]
                ref.tell((ADD, [cmd.value]))
                ctx.ask(ref, (GET, [0.0]), lambda got, exc: CounterReplied(
                    cmd, float(got[0]) if exc is None else 0.0,
                    "" if exc is None else repr(exc)), ACTOR_TIMEOUT)
                return Effect.none()
            if isinstance(cmd, CounterReplied):
                if cmd.error:
                    return Effect.reply(cmd.cmd.reply_to, ("error",
                                                           cmd.error))
                return Effect.persist((cmd.cmd.counter, cmd.cmd.value,
                                       cmd.total)).then_reply(
                    cmd.cmd.reply_to, lambda s: ("ok", cmd.total, s[0]))
            if isinstance(cmd, LedgerState):
                return Effect.reply(cmd.reply_to, state)
            if isinstance(cmd, Poison):
                raise RuntimeError(f"ledger {i}: poison command")
            return Effect.none()   # the Receptionist's Registered ack

        def recovered(_state, _ctx):
            recovery[i] = (t0, time.perf_counter())

        return EventSourcedBehavior(
            PersistenceId.of("Ledger", str(i)), (0, 0.0, 0.0), on_command,
            ledger_event,
            retention=RetentionCriteria.snapshot_every_n(TP_SNAPSHOT_EVERY),
            recovery_completed=recovered)
    return Behaviors.setup(setup)


def ledger_guardian(recovery: dict):
    """The typed guardian: spawns TP_COUNTERS slots_counter device actors
    (one block, through TypedActorContext.spawn with device_props on the
    ledger dispatcher), TP_LEDGERS - 1 ledgers and ledger 0 under a
    BackoffSupervisor (min backoff TP_BACKOFF, no jitter); answers
    GetRefs with (the counter block, ledger 0's supervisor)."""
    def setup(ctx):
        counters = ctx.spawn(None, "counters", props=device_props(
            slots_counter, n=TP_COUNTERS, dispatcher=TP_DISPATCHER))
        sup = ctx.spawn(None, "ledger-0-backoff", props=BackoffSupervisor
                        .props(props_from_behavior(ledger(0, counters,
                                                          recovery)),
                               "ledger-0", TP_BACKOFF, 4 * TP_BACKOFF,
                               random_factor=0.0))
        for i in range(1, TP_LEDGERS):
            ctx.spawn(ledger(i, counters, recovery), f"ledger-{i}")

        def on_message(msg):
            if isinstance(msg, GetRefs):
                msg.reply_to.tell((counters, sup))
            return Behaviors.same
        return Behaviors.receive_message(on_message)
    return Behaviors.setup(setup)


def ledger_system(directory: str, name: str):
    """A typed ActorSystem on the file journal and the local snapshot
    store under `directory` (absolute dirs), with the ledger dispatcher:
    actor_ask's full-width shape (2^20 rows, 4 bounded slots: K2,
    pipeline depth 4, 256 promise rows). Returns (system, recovery
    dict, counter block, ledger 0's supervisor, the file journal)."""
    cfg = {"akka": {"stdout-loglevel": "OFF", "log-dead-letters": 0,
                    "actor": {"ledger-dispatcher": dict(ASK_DISPATCHER)},
                    "persistence": {
                        "journal": {"plugin": "akka.persistence.journal.file",
                                    "file": {"dir": os.path.join(
                                        directory, "journal")}},
                        "snapshot-store": {
                            "plugin": "akka.persistence.snapshot-store.local",
                            "local": {"dir": os.path.join(
                                directory, "snapshots")}}}}}
    recovery: dict = {}
    system = TypedActorSystem.create(ledger_guardian(recovery), name, cfg)
    classic = system.classic
    counters, sup = ask(system.guardian, lambda r: GetRefs(r),
                        timeout=ACTOR_TIMEOUT,
                        system=classic).result(ACTOR_TIMEOUT)
    journal = Persistence.get(classic).journal_plugin_for()
    return system, recovery, counters, sup, journal


def find_ledgers(system) -> dict:
    """The ledgers by index, through the Receptionist's Find (polled until
    all TP_LEDGERS have registered)."""
    classic = system.classic
    rec = Receptionist.get(classic)
    deadline = time.monotonic() + ACTOR_TIMEOUT
    while True:
        listing = ask(rec.ref, lambda r: Find(TP_KEY, r),
                      timeout=ACTOR_TIMEOUT,
                      system=classic).result(ACTOR_TIMEOUT)
        check(isinstance(listing, Listing), "typed_persistence: a Listing")
        refs = {int(r.path.name.split("-")[1]): r
                for r in listing.service_instances}
        if len(refs) == TP_LEDGERS:
            return refs
        check(time.monotonic() < deadline, f"typed_persistence: "
              f"{len(refs)} of {TP_LEDGERS} ledgers registered")
        time.sleep(0.01)


def timed_writes(journal, out: list) -> None:
    """Time every write_atomic of the file journal (host clock)."""
    write = journal.write_atomic

    def timed(aw):
        t = time.perf_counter()
        try:
            return write(aw)
        finally:
            out.append(time.perf_counter() - t)
    journal.write_atomic = timed


def ledger_states(refs: dict, classic) -> dict:
    futs = {i: ask(r, lambda to: LedgerState(to), timeout=ACTOR_TIMEOUT,
                   system=classic) for i, r in refs.items()}
    return {i: f.result(ACTOR_TIMEOUT) for i, f in futs.items()}


def typed_persistence_paths(launches: dict) -> dict:
    """typed_persistence (ROADMAP A12.1): a typed ActorSystem whose
    guardian spawns TP_COUNTERS device counters (K2 at S = 4, m = 2^20 +
    4096) and TP_LEDGERS event-sourced ledgers on the file journal and
    local snapshot store; TP_ROUNDS rounds of TP_CONC commands (seed 5,
    counters distinct within a round, ledgers uniform) sent to the
    ledgers found through the Receptionist; every reply, every counter's
    device state and every ledger's state held to a host oracle. Then a
    fresh system on the same dirs: every ledger recovers from its
    snapshot plus the tail to the oracle, PersistenceQuery's current
    events of two ledgers equal what they persisted, and ledger 0 under
    its BackoffSupervisor crashes on a poison command, restarts after
    its minimum backoff, recovers and answers the next command. Returns
    K2's fullest carried inbox of all the rounds (counted after every
    step)."""
    label = "typed_persistence"
    rng = np.random.default_rng(5)
    oracle = np.zeros(TP_COUNTERS)
    # each ledger's events by sequence number, as its replies number them
    # (a ledger persists in the order its counters reply)
    events = {i: {} for i in range(TP_LEDGERS)}
    lat, bad, writes = [], [], []
    flat = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_",
                                     ignore_cleanup_errors=True) as d:
        t0 = time.perf_counter()
        system, _, counters, _, journal = ledger_system(d, "ledgers")
        classic = system.classic
        try:
            timed_writes(journal, writes)
            refs = find_ledgers(system)
            h = get_handle(classic, TP_DISPATCHER)
            check(h.runtime.spill_cap == 0 and
                  h.runtime.mailbox_slots == ASK_SLOTS,
                  f"{label}: bounded slots mailboxes")
            print(f"{label} setup_s {time.perf_counter() - t0}")

            def command_round():
                picks = rng.choice(TP_COUNTERS, TP_CONC, replace=False)
                vals = rng.integers(1, 100, TP_CONC).astype(np.float64)
                owners = rng.integers(0, TP_LEDGERS, TP_CONC)
                futs = []
                for k, v, j in zip(picks, vals, owners):
                    oracle[k] += v
                    ev = (int(k), float(v), float(oracle[k]))
                    t = time.perf_counter()
                    f = ask(refs[int(j)], lambda r, k=ev[0], v=ev[1]:
                            LedgerAdd(k, v, r), timeout=ACTOR_TIMEOUT,
                            system=classic)
                    f.add_done_callback(
                        lambda _f, t=t: lat.append(time.perf_counter() - t))
                    futs.append((int(j), ev, f))
                for j, ev, f in futs:
                    got = f.result(ACTOR_TIMEOUT)
                    if got[:2] != ("ok", ev[2]) or got[2] in events[j]:
                        bad.append((got, ev))
                    else:
                        events[j][got[2]] = ev

            def drive():
                # a live-row count after every step of every round (a sync
                # a step, inside the timed window): K2's input is the
                # fullest carried inbox of all the rounds
                t = time.perf_counter()
                with StepProbe(h.runtime, live=True) as live:
                    for _ in range(TP_ROUNDS):
                        command_round()
                return time.perf_counter() - t, live

            (wall, live), steps, count = handle_window(h, drive)
            check(not bad, f"{label}: every reply equals the oracle "
                  f"({bad[:4]})")
            n_cmd = TP_ROUNDS * TP_CONC
            check(len(lat) == n_cmd and len(writes) == n_cmd,
                  f"{label}: {len(lat)} replies, {len(writes)} journal "
                  f"writes of {n_cmd} commands")
            check(np.array_equal(counters.read_state("count"),
                                 oracle.astype(np.float32)),
                  f"{label}: every counter's device state equals the "
                  f"oracle")
            events = {i: [ev[n] for n in range(1, len(ev) + 1)]
                      for i, ev in events.items()}  # KeyError: a gap
            want_states = {i: ledger_event_fold(ev)
                           for i, ev in events.items()}
            check(ledger_states(refs, classic) == want_states,
                  f"{label}: every ledger's state equals the oracle")
            store = LocalSnapshotStore(os.path.join(d, "snapshots"))
            deadline = time.monotonic() + ACTOR_TIMEOUT
            for i, ev in events.items():   # the snapshot store's writes
                while snapshot_of(store, i)[0] != last_snapshot(ev):
                    check(time.monotonic() < deadline, f"{label}: ledger "
                          f"{i}'s snapshot written")
                    time.sleep(0.01)
            print(f"{label} commands_per_s {n_cmd / wall} command "
                  f"{json.dumps(pcts_us(lat))} journal_write "
                  f"{json.dumps(pcts_us(writes))} (host clock)")
            replays, busy = len(live.events), live.busy_ms
            print(f"{label} steps {steps} replays {replays} wall_ms "
                  f"{wall * 1e3} busy_ms {busy} busy_share "
                  f"{busy / (wall * 1e3)} (CUDA events around each replay)")
            inputs, n = live.inputs if live.inputs is not None else (None, 0)
            check(live.rows > 0 and int(inputs[3].sum()) > 0,
                  f"{label}: K2's input carries messages ({live.rows} rows)")
            print(f"{label} kernel_input live_rows {live.rows} of "
                  f"{inputs[0].shape[0]}")
            count.report(label, "ring_slots", launches, steps)
            flat[label] = ("K2", (inputs, n), ASK_SLOTS)
            pool = h.ask_pool_stats()
            check(pool["in_flight"] == 0, f"{label}: no ask left in flight")
        finally:
            system.terminate()
        check(system.await_termination(ACTOR_TIMEOUT),
              f"{label}: the system terminated")
        del system, counters, refs, h, journal
        free()

        # a fresh system on the same dirs
        t0 = time.perf_counter()
        system, recovery, counters, sup, _ = ledger_system(d, "ledgers-2")
        classic = system.classic
        try:
            refs = find_ledgers(system)
            states = ledger_states(refs, classic)
            check(states == want_states, f"{label}: every ledger recovered "
                  f"to the oracle")
            check(sorted(recovery) == list(range(TP_LEDGERS)),
                  f"{label}: every ledger completed its recovery")
            rec_s = [b - a for a, b in recovery.values()]
            snapped = 0
            for i, ev in events.items():
                last = last_snapshot(ev)
                check(snapshot_of(store, i) ==
                      (last, ledger_event_fold(ev[:last]) if last else None),
                      f"{label}: ledger {i}'s snapshot at {last}")
                snapped += last > 0
            print(f"{label} recovery_s {time.perf_counter() - t0} "
                  f"recovery {json.dumps(pcts_us(rec_s))} max_us "
                  f"{max(rec_s) * 1e6} of {TP_LEDGERS} ledgers ({snapped} "
                  f"from a snapshot plus the tail, the rest from the journal; "
                  f"spawn to recovery completed, host clock)")
            rj = PersistenceQuery.get(classic).read_journal_for()
            for i in (1, TP_LEDGERS - 1):
                envs = rj.current_events_by_persistence_id(
                    PersistenceId.of("Ledger", str(i)).id)
                check([(e.sequence_nr, e.event) for e in envs] ==
                      list(enumerate(events[i], 1)),
                      f"{label}: the query's events of ledger {i}")

            # ledger 0 under its BackoffSupervisor: a poison command stops
            # it; a command sent once the supervisor counted the restart
            # waits in its buffer for the new incarnation
            t = time.perf_counter()
            sup.tell(Poison())

            def restarts() -> int:
                rc = ask(sup, GetRestartCount(), timeout=ACTOR_TIMEOUT,
                         system=classic).result(ACTOR_TIMEOUT)
                check(isinstance(rc, RestartCount), f"{label}: {rc}")
                return rc.count

            while restarts() == 0:
                check(time.perf_counter() - t < ACTOR_TIMEOUT,
                      f"{label}: no restart counted")
                time.sleep(0.005)
            k, v = int(rng.integers(TP_COUNTERS)), 7.0
            got = ask(sup, lambda r: LedgerAdd(k, v, r),
                      timeout=ACTOR_TIMEOUT,
                      system=classic).result(ACTOR_TIMEOUT)
            after = time.perf_counter() - t
            # a fresh system's counters start at 0
            check(got == ("ok", v, len(events[0]) + 1),
                  f"{label}: the restarted ledger answers {got}")
            check(after >= TP_BACKOFF, f"{label}: the restart waited its "
                  f"backoff ({after} s)")
            check(restarts() == 1, f"{label}: GetRestartCount gives 1")
            events[0].append((k, v, v))
            new0 = ask(sup, lambda r: LedgerState(r), timeout=ACTOR_TIMEOUT,
                       system=classic).result(ACTOR_TIMEOUT)
            check(new0 == ledger_event_fold(events[0]),
                  f"{label}: the restarted ledger recovered the journal")
            print(f"{label} backoff poison_to_reply_s {after} "
                  f"restart_count 1")
        finally:
            system.terminate()
        check(system.await_termination(ACTOR_TIMEOUT),
              f"{label}: the fresh system terminated")
        del system, counters, sup, refs
        free()
    return flat


def last_snapshot(evs) -> int:
    """The sequence number of a ledger's last snapshot (0: none)."""
    return len(evs) // TP_SNAPSHOT_EVERY * TP_SNAPSHOT_EVERY


def snapshot_of(store, i: int) -> tuple:
    """(sequence number, state) of ledger i's latest snapshot on disk
    ((0, None): none)."""
    sel = store.load(PersistenceId.of("Ledger", str(i)).id,
                     SnapshotSelectionCriteria.latest())
    return (0, None) if sel is None else (sel.metadata.sequence_nr,
                                          sel.snapshot)


def ledger_event_fold(evs) -> tuple:
    state = (0, 0.0, 0.0)
    for ev in evs:
        state = ledger_event(state, ev)
    return state



# --------------------------------------- device actors across nodes
REMOTE_ROUNDS, REMOTE_CONC = 16, 256   # remote_ask's rounds of asks a leg
CR_ROUNDS = 8               # cluster_router's rounds before and after
CR_COUNTERS = 1024          # reduce counters on each cluster node
REMOTE_PHASE_S = 60.0       # the phase's limit
LANE_ELEMS = 1 << 16        # the card tensor told over the large lane
PKI_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                       "data", "torch_pki")
# a reduce-mode dispatcher (K1) of a cluster node: 2^20 rows, depth 4
CR_DISPATCHER = {"type": "tpu-batched", "capacity": N,
                 "payload-width": PAYLOAD_W, "mailbox-slots": 0,
                 "promise-rows": 256, "host-inbox": 4096,
                 "pipeline-depth": 4}
# remote deathwatch's detector at the same pace (default: 1 s, 10 s)
FAST_WATCH = {"heartbeat-interval": "0.1s",
              "acceptable-heartbeat-pause": "2s",
              "expected-first-heartbeat-estimate": "0.1s"}


def node_config(transport: str, provider: str = "remote",
                dispatcher=None, cluster=None) -> dict:
    """A node on the in-proc transport or on TCP / TLS (the committed
    test PKI, tests/data/torch_pki) at 127.0.0.1, port 0."""
    rem = {"transport": transport,
           "canonical": {"hostname": "local" if transport == "inproc"
                         else "127.0.0.1", "port": 0},
           "watch-failure-detector": dict(FAST_WATCH)}
    if transport == "tls-tcp":
        rem["tls"] = {"cert-file": os.path.join(PKI_DIR, "node0.crt"),
                      "key-file": os.path.join(PKI_DIR, "node0.key"),
                      "ca-file": os.path.join(PKI_DIR, "ca.crt")}
    actor = {"provider": provider}
    if dispatcher is not None:
        actor["node-dispatcher"] = dict(dispatcher)
    akka = {"stdout-loglevel": "OFF", "log-dead-letters": 0,
            "actor": actor, "remote": rem}
    if cluster is not None:
        akka["cluster"] = cluster
    return {"akka": akka}


def then(fut: Future, fn) -> Future:
    """A future of fn(fut's result); a failure passes through."""
    out: Future = Future()

    def done(f):
        if f.exception() is not None:
            out.set_exception(f.exception())
        else:
            out.set_result(fn(f.result()))

    fut.add_done_callback(done)
    return out


class Front(Actor):
    """A node's host front of its device counters (a device actor replies
    to asks only, through its promise rows): (i, v) adds v to counter i
    and pipes (node, i, total) to the sender. A slots counter takes the
    add as a tell and a GET ask; a reduce counter one ask carrying the
    add (a reduce row takes one ask a step)."""

    def __init__(self, block, node: str, reduce: bool):
        super().__init__()
        self.refs = [block[i] for i in range(len(block))]
        self.node, self.reduce = node, reduce

    def receive(self, message):
        i, v = message
        ref = self.refs[i]
        if self.reduce:
            fut = ref.ask([v], timeout=ACTOR_TIMEOUT)
        else:
            ref.tell((ADD, [v]))
            fut = ref.ask((GET, [0.0]), timeout=ACTOR_TIMEOUT)
        pipe(then(fut, lambda r: (self.node, i, float(r[0]))), self.sender,
             self.self_ref)


class Sink(Actor):
    """Hands every message to a future (the large lane's arrival)."""

    def __init__(self, out: Future):
        super().__init__()
        self.out = out

    def receive(self, message):
        self.out.set_result(message)


def addr_of(system) -> str:
    return str(system.provider.local_address)


def ask_rounds(target, system, rounds: int, n: int, check_reply,
               rng, lat: list) -> float:
    """`rounds` rounds of REMOTE_CONC asks (i, v) of `target` from
    `system`, a round's counters (of n) distinct (numpy rng), each reply
    held by check_reply(reply, i, v); returns the wall seconds."""
    t0 = time.perf_counter()
    for _ in range(rounds):
        picks = rng.choice(n, REMOTE_CONC, replace=False)
        vals = rng.integers(1, 100, REMOTE_CONC).astype(np.float64)
        futs = []
        for i, v in zip(picks, vals):
            t = time.perf_counter()
            f = ask(target, (int(i), float(v)), timeout=ACTOR_TIMEOUT,
                    system=system)
            f.add_done_callback(
                lambda _f, t=t: lat.append(time.perf_counter() - t))
            futs.append((int(i), float(v), f))
        for i, v, f in futs:
            check_reply(f.result(ACTOR_TIMEOUT), i, v)
    return time.perf_counter() - t0


def remote_ask(transport: str, launches: dict, flat: dict) -> str:
    """remote_ask_<transport>: node B holds actor_ask's dispatcher shape
    (2^20 rows, 4 bounded slots: K2, depth 4, 256 promise rows), 4096
    slots counters and a Front at /user/front; node A resolves B's front
    (a RemoteActorRef) and sends REMOTE_ROUNDS rounds of REMOTE_CONC
    asks (seed 5), each reply held to a host oracle, with a live-row
    count after every step (K2's input: the fullest carried inbox). Then
    a remote tell to a DeviceActorRef path, read back; on TCP a card
    tensor over the large-message lane; a remote watch of a device ref
    that B stops. Returns the leg's label."""
    label = f"remote_ask_{'tls' if transport == 'tls-tcp' else transport}"
    did = "akka.actor.node-dispatcher"
    t0 = time.perf_counter()
    a = ActorSystem.create(f"{label}-a", node_config(transport))
    b = ActorSystem.create(f"{label}-b", node_config(
        transport, dispatcher=ASK_DISPATCHER))
    try:
        block = b.actor_of(device_props(slots_counter, n=ASK_ACTORS,
                                        dispatcher=did), "counters")
        direct = b.actor_of(device_props(slots_counter, dispatcher=did),
                            "direct")
        mortal = b.actor_of(device_props(slots_counter, dispatcher=did),
                            "mortal")
        b.actor_of(Props.create(Front, block, "B", False), "front")
        h = get_handle(b, did)
        rt = h.runtime
        check(rt.spill_cap == 0 and rt.mailbox_slots == ASK_SLOTS,
              f"{label}: bounded slots mailboxes")
        front = a.provider.resolve_actor_ref(f"{addr_of(b)}/user/front")
        check(isinstance(front, RemoteActorRef),
              f"{label}: B's front is a RemoteActorRef on A")
        print(f"{label} setup_s {time.perf_counter() - t0} a "
              f"{addr_of(a)} b {addr_of(b)}")
        rng = np.random.default_rng(5)
        oracle = np.zeros(ASK_ACTORS)
        lat, bad = [], []

        def hold(reply, i, v):
            oracle[i] += v
            if reply != ("B", i, oracle[i]):
                bad.append((reply, i, oracle[i]))

        def drive():
            with StepProbe(h.runtime, live=True) as live:
                wall = ask_rounds(front, a, REMOTE_ROUNDS, ASK_ACTORS,
                                  hold, rng, lat)
            return wall, live

        (wall, live), steps, count = handle_window(h, drive)
        n_ask = REMOTE_ROUNDS * REMOTE_CONC
        check(not bad, f"{label}: replies equal the oracle ({bad[:4]})")
        check(len(lat) == n_ask, f"{label}: every ask resolved")
        check(np.array_equal(block.read_state("count"),
                             oracle.astype(np.float32)),
              f"{label}: every counter equals the oracle")
        replays, busy = len(live.events), live.busy_ms
        print(f"{label} asks_per_s {n_ask / wall} ask "
              f"{json.dumps(pcts_us(lat))} (host clock)")
        print(f"{label} steps {steps} replays {replays} wall_ms "
              f"{wall * 1e3} busy_ms {busy} busy_share "
              f"{busy / (wall * 1e3)} (CUDA events around each replay)")
        inputs, n = live.inputs if live.inputs is not None else (None, 0)
        check(live.rows > 0 and int(inputs[3].sum()) > 0,
              f"{label}: K2's input carries messages ({live.rows} rows)")
        print(f"{label} kernel_input live_rows {live.rows} of "
              f"{inputs[0].shape[0]}")
        count.report(label, "ring_slots", launches, steps)
        flat[label] = ("K2", (inputs, n), ASK_SLOTS)
        check(h.ask_pool_stats()["in_flight"] == 0,
              f"{label}: no ask left in flight")

        # a remote tell to a DeviceActorRef path, read back on B
        canonical = f"{addr_of(b)}/user/direct"
        check(b.provider.resolve_actor_ref(canonical) is direct,
              f"{label}: B resolves its canonical path to the device ref")
        remote_direct = a.provider.resolve_actor_ref(canonical)
        check(isinstance(remote_direct, RemoteActorRef),
              f"{label}: A resolves it to a RemoteActorRef")
        remote_direct.tell((ADD, [7.0]))
        deadline = time.monotonic() + ACTOR_TIMEOUT
        while float(direct.ask((GET, [0.0]),
                               timeout=ACTOR_TIMEOUT).result(
                                   ACTOR_TIMEOUT)[0]) != 7.0:
            check(time.monotonic() < deadline,
                  f"{label}: the remote tell reached the row")
            time.sleep(0.005)

        if transport == "tcp":
            # a card tensor over the large-message lane
            arrived: Future = Future()
            b.actor_of(Props.create(Sink, arrived), "sink")
            sink = a.provider.resolve_actor_ref(f"{addr_of(b)}/user/sink")
            x = torch.arange(LANE_ELEMS, device="cuda",
                             dtype=torch.float32) * 0.5 - 3.0
            t = time.perf_counter()
            sink.tell(x)
            got = arrived.result(ACTOR_TIMEOUT)
            lane_ms = (time.perf_counter() - t) * 1e3
            check(isinstance(got, np.ndarray) and torch.equal(
                torch.from_numpy(got).cuda(), x),
                f"{label}: the tensor arrived equal")
            lanes = {k[2] for k in a.provider.transport._conns}
            check("large" in lanes and lanes - {"large"},
                  f"{label}: the large lane and another were used "
                  f"({lanes})")
            print(f"{label} large_lane {LANE_ELEMS} float32 "
                  f"({LANE_ELEMS * 4} bytes) tell_to_arrival_ms {lane_ms} "
                  f"lanes {sorted(lanes)}")

        # a remote watch of a device ref that B stops
        remote_mortal = a.provider.resolve_actor_ref(
            f"{addr_of(b)}/user/mortal")
        probe = TestProbe(a)
        probe.watch(remote_mortal)
        deadline = time.monotonic() + ACTOR_TIMEOUT
        while not any(isinstance(w, RemoteActorRef)
                      for w in mortal._watched_by):
            check(time.monotonic() < deadline,
                  f"{label}: the Watch reached B")
            time.sleep(0.005)
        mortal.stop()
        term = probe.expect_terminated(remote_mortal, ACTOR_TIMEOUT)
        check(term.actor.path.elements == ("user", "mortal"),
              f"{label}: A got Terminated of B's device ref")
        graph_line(label, h.runtime)
    finally:
        for s in (a, b):
            s.terminate()
    for s in (a, b):
        check(s.await_termination(ACTOR_TIMEOUT),
              f"{label}: {s.name} terminated")
    del a, b, block, direct, mortal, h, rt
    free()
    return label


def cluster_router(launches: dict, flat: dict) -> None:
    """cluster_router: three provider = cluster nodes over TCP loopback
    (the reference's fast gossip settings, keep-majority), each with a
    reduce-mode dispatcher (2^20 rows: K1), CR_COUNTERS counters and a
    Front at /user/front; on node 0 a ClusterRouterGroup of
    RoundRobinGroup(["/user/front"]) with local routees reaches 3
    routees; CR_ROUNDS rounds of REMOTE_CONC asks through it, each reply
    (node, counter, total) held to that node's oracle; node 0 watches
    node 2's front; node 2 crashes (its transport shut, then terminated);
    the survivors drop it (keep-majority downs it, the leader removes
    it), the router falls to 2 routees, node 0 gets Terminated; CR_ROUNDS
    more rounds. K1 launches once a step on every node's handle."""
    label = "cluster_router"
    did = "akka.actor.node-dispatcher"
    t0 = time.perf_counter()
    systems = [ActorSystem.create(f"cr{i}", node_config(
        "tcp", "cluster", CR_DISPATCHER, FAST_MEMBERSHIP))
        for i in range(3)]
    try:
        blocks, handles = [], []
        for i, s in enumerate(systems):
            blocks.append(s.actor_of(device_props(
                counter_behavior(PAYLOAD_W), n=CR_COUNTERS, dispatcher=did),
                "counters"))
            s.actor_of(Props.create(Front, blocks[-1], f"cr{i}", True),
                       "front")
            handles.append(get_handle(s, did))
            handles[-1].runtime
        print(f"{label} setup_s {time.perf_counter() - t0}")
        clusters = [Cluster.get(s) for s in systems]

        def up(c):
            return sum(m.status is MemberStatus.UP for m in c.state.members)

        def wait_for(cond, what):
            deadline = time.monotonic() + ACTOR_TIMEOUT
            while not cond():
                check(time.monotonic() < deadline, f"{label}: {what}")
                time.sleep(0.005)

        t0 = time.perf_counter()
        for c in clusters:
            c.join(addr_of(systems[0]))
        wait_for(lambda: all(up(c) == 3 for c in clusters),
                 "the three nodes are Up")
        form_s = time.perf_counter() - t0
        router = systems[0].actor_of(Props.create(Echo).with_router(
            ClusterRouterGroup(RoundRobinGroup(["/user/front"]),
                               ClusterRouterGroupSettings(
                                   total_instances=3,
                                   routees_paths=("/user/front",),
                                   allow_local_routees=True))), "router")

        def routees() -> int:
            return len(ask(router, GetRoutees(), timeout=ACTOR_TIMEOUT,
                           system=systems[0]).result(
                               ACTOR_TIMEOUT).routees)

        wait_for(lambda: routees() == 3, "the router reaches 3 routees")
        print(f"{label} form_s {form_s} routees 3 leader "
              f"{clusters[0].state.leader}")
        rng = np.random.default_rng(5)
        oracle = {f"cr{i}": np.zeros(CR_COUNTERS) for i in range(3)}
        bad, by_node = [], {}

        def hold(reply, i, v):
            node, j, total = reply
            by_node[node] = by_node.get(node, 0) + 1
            if node not in oracle or j != i:
                bad.append((reply, i, v))
                return
            oracle[node][i] += v
            if total != oracle[node][i]:
                bad.append((reply, i, v, oracle[node][i]))

        def leg(hs, tag):
            lat: list = []
            with StepProbe(handles[0].runtime, live=True) as live:
                (wall, steps, count) = handles_window(
                    hs, lambda: ask_rounds(router, systems[0], CR_ROUNDS,
                                           CR_COUNTERS, hold, rng, lat))
            n_ask = CR_ROUNDS * REMOTE_CONC
            check(not bad, f"{label}: replies equal each node's oracle "
                  f"({bad[:4]})")
            check(len(lat) == n_ask, f"{label}: every ask resolved")
            print(f"{label} {tag} asks_per_s {n_ask / wall} ask "
                  f"{json.dumps(pcts_us(lat))} replies_by_node "
                  f"{dict(sorted(by_node.items()))} steps_by_node {steps}")
            return steps, count, live

        steps_b, count_b, live_b = leg(handles, "before")
        check(len(by_node) == 3, f"{label}: every node answered")
        # node 0 watches node 2's front, through its remote watcher
        probe = TestProbe(systems[0])
        front2 = systems[0].provider.resolve_actor_ref(
            f"{addr_of(systems[2])}/user/front")
        probe.watch(front2)
        watcher = systems[0].provider._remote_watcher.cell.actor
        wait_for(lambda: watcher.fd.is_monitoring(addr_of(systems[2])),
                 "node 0's remote watcher hears node 2")
        crashed = addr_of(systems[2])
        t0 = time.perf_counter()
        systems[2].provider.shutdown_transport()
        systems[2].terminate()
        wait_for(lambda: all(crashed not in {m.address_str
                                             for m in c.state.members}
                             for c in clusters[:2]),
                 "the survivors removed node 2")
        removed_s = time.perf_counter() - t0
        wait_for(lambda: routees() == 2, "the router fell to 2 routees")
        term = probe.expect_terminated(front2, ACTOR_TIMEOUT)
        check(term.address_terminated, f"{label}: node 0 got Terminated "
              f"of node 2's front (address terminated)")
        terminated_s = time.perf_counter() - t0
        check(systems[2].await_termination(ACTOR_TIMEOUT),
              f"{label}: node 2 terminated")
        print(f"{label} crash_to_removed_s {removed_s} "
              f"crash_to_terminated_s {terminated_s} members "
              f"{[len(c.state.members) for c in clusters[:2]]}")
        by_node.clear()
        steps_a, count_a, live_a = leg(handles[:2], "after")
        check(set(by_node) == {"cr0", "cr1"},
              f"{label}: only the survivors answered")
        for blk, node in zip(blocks[:2], ("cr0", "cr1")):
            check(np.array_equal(blk.read_state("total"),
                                 oracle[node].astype(np.float32)),
                  f"{label}: {node}'s counters equal its oracle")
        for k, v in count_a.counts.items():
            count_b.counts[k] += v
        steps = sum(steps_b) + sum(steps_a)
        per_node = [b + a for b, a in zip(steps_b, steps_a + [0])]
        print(f"{label} k1_launches_by_node {per_node} (one a step)")
        count_b.report(label, "ring_reduce", launches, steps)
        live = max((live_b, live_a), key=lambda x: x.rows)
        inputs = live.inputs
        check(live.rows > 0 and int(inputs[0][3].sum()) > 0,
              f"{label}: K1's input carries messages ({live.rows} rows)")
        print(f"{label} kernel_input live_rows {live.rows} of "
              f"{inputs[0][0].shape[0]} (node 0)")
        flat[label] = ("K1", inputs, SLOTS)
    finally:
        for s in systems:
            s.terminate()
    for s in systems:
        check(s.await_termination(ACTOR_TIMEOUT),
              f"{label}: {s.name} terminated")
    del systems, blocks, handles
    free()


def remote_paths(launches: dict) -> dict:
    """remote_ask over inproc, TCP and TLS, then cluster_router; returns
    each path's delivery inputs as (kernel, (inputs, n), slots)."""
    flat: dict = {}
    for transport in ("inproc", "tcp", "tls-tcp"):
        t0 = time.perf_counter()
        label = remote_ask(transport, launches, flat)
        print(f"{label} phase_s {time.perf_counter() - t0}")
    t0 = time.perf_counter()
    cluster_router(launches, flat)
    print(f"cluster_router phase_s {time.perf_counter() - t0}")
    return flat


def remote_phase_only(runs: int, smi: str) -> int:
    """`python3 chip_smoke.py --remote-phase N`: remote_paths alone, N
    times in one process (the spread of its seconds on the host clock),
    every check as in the whole run, K1 and K2 launched in each run. The
    last line is {"remote_phase_s": [...]}."""
    times = []
    for r in range(runs):
        launches: Dict[str, dict] = {}
        t0 = time.perf_counter()
        remote_paths(launches)
        times.append(time.perf_counter() - t0)
        k1 = sum(c["ring_reduce"] for c in launches.values())
        k2 = sum(c["ring_slots"] for c in launches.values())
        check(k1 > 0 and k2 > 0, f"remote_paths run {r}: K1 {k1} and K2 "
              f"{k2} launches")
        print(f"remote_phase_run {r} remote_phase_s {times[-1]} "
              f"k1_launches {k1} k2_launches {k2}")
    print(smi)
    print(json.dumps({"remote_phase_s": times}))
    return 0


# ------------------------- replicated state and cluster tools (ROADMAP A12.3)
DD_PHASE_S = 60.0           # the phase's limit
DD_READS = 64               # entities each replica reader is asked for
DD_LEASE_WAVES = 4          # waves after the lease leg's rebalance
# the replicator at the fast settings of the reference's tests
# (ReplicatorSettings: gossip 0.1 s, delta propagation and notify 0.05 s)
DD_REPLICATOR = {"gossip-interval": "0.1s",
                 "notify-subscribers-interval": "0.05s",
                 "delta-crdt": {"delta-propagation-interval": "0.05s"}}
# cluster_router's membership settings with the lease-majority resolver
DD_CLUSTER = {**{k: v for k, v in FAST_MEMBERSHIP.items()
                 if k != "split-brain-resolver"},
              "split-brain-resolver": {
                  "active-strategy": "lease-majority", "stable-after": "1s",
                  "lease-majority": {
                      "lease-name": "ddata-sbr",
                      "lease-implementation": "in-proc",
                      "heartbeat-timeout": "2s",
                      "acquire-lease-delay-for-minority": 2.0}},
              "distributed-data": DD_REPLICATOR,
              # node 0's metrics extension samples the card
              "metrics": {"collect-interval": "0.1s",
                          "gossip-interval": "0.1s", "probe-device": True}}
DD_KEY = ServiceKey("replica-reader")
# the region's system is probed where each run flushes its staged tells
DD_PROBE = ("_flush_staged", flat_inputs)


def ddata_region(store, lease, device: str = "cuda"):
    """gateway_region(0)'s full-width counter region (K1) with a remember
    store and a coordination lease."""
    return DeviceShardRegion(DeviceEntity(
        "counter", counter_behavior(PAYLOAD_W), n_shards=256,
        entities_per_shard=4096, n_devices=1, spare_blocks=2,
        mailbox_slots=0, remember_store=store, lease=lease), device=device)


class Visible:
    """Publish-to-visible on a peer's replica cache: each published wave
    (its step stamp and entities) is visible once the peer's view holds
    every one of its entities at that step or later; the peer's ingest is
    wrapped to take the time."""

    def __init__(self, cache):
        self.cache, self.pending, self.lat = cache, [], []
        self._lock = threading.Lock()
        ingest = cache._ingest_map

        def wrapped(data):
            ingest(data)
            now = time.perf_counter()
            with cache._lock:
                view = dict(cache._replica)
            with self._lock:
                left = []
                for t, step, names in self.pending:
                    if all(n in view and view[n][1] >= step for n in names):
                        self.lat.append(now - t)
                    else:
                        left.append((t, step, names))
                self.pending = left

        cache._ingest_map = wrapped

    def mark(self, step: int, names) -> None:
        with self._lock:
            self.pending.append((time.perf_counter(), step, list(names)))


class ReplicaReader(Actor):
    """A node's host reader of its replica cache: a list of entity ids is
    answered with (node, [(id, total, step), ...]) from the cache's view
    (None where the view has no entry)."""

    def __init__(self, cache, node: str):
        super().__init__()
        self.cache, self.node = cache, node

    def receive(self, message):
        with self.cache._lock:
            view = dict(self.cache._replica)
        self.sender.tell((self.node, [(n, *view.get(n, (None, None)))
                                      for n in message]), self.self_ref)


def dd_wait(cond, what: str, limit: float = 10.0,
            label: str = "ddata_paths") -> float:
    """Poll cond() until true; fails after `limit` s. Returns the wait."""
    t0 = time.perf_counter()
    while not cond():
        check(time.perf_counter() - t0 < limit, f"{label}: {what}")
        time.sleep(0.005)
    return time.perf_counter() - t0


def dd_waves(region, trace, oracle: dict, cache, seen, count,
             split: dict) -> int:
    """Each wave through ask_many (launches counted), every reply held to
    the oracle's running total; after each wave ONE publish of its
    post-wave totals to the replica cache, marked on the peer's probe.
    Returns the region steps taken; adds the host seconds of the waves'
    entity lookups (a wave's new ids go to the remember store in one
    batch), asks and publishes to `split`."""
    s0 = region.system._host_step
    for asks in trace:
        t0 = time.perf_counter()
        refs = region.entity_refs([n for n, _ in asks])
        t1 = time.perf_counter()
        out = count(lambda: region.ask_many(
            [(r.shard, r.index, [v]) for r, (_, v) in zip(refs, asks)]))
        t2 = time.perf_counter()
        totals = {}
        for (n, v), o in zip(asks, out):
            check(not isinstance(o, BaseException), f"ddata_paths: {o!r}")
            oracle[n] = oracle.get(n, 0.0) + v
            check(float(o[0]) == oracle[n], f"ddata_paths: reply {o[0]} "
                  f"== oracle {oracle[n]} for {n}")
            totals[n] = float(o[0])
        cache.publish_wave(totals)
        seen.mark(int(region.system._host_step), totals)
        t3 = time.perf_counter()
        for k, dt in (("refs", t1 - t0), ("asks", t2 - t1),
                      ("publish", t3 - t2)):
            split[k] = split.get(k, 0.0) + dt
    return region.system._host_step - s0


def ddata_paths(launches: dict, device: str = "cuda") -> dict:
    """ddata_paths (ROADMAP A12.3): three provider = cluster nodes over
    TCP loopback (cluster_router's membership, lease-majority over the
    in-proc lease, the replicator at the fast settings). Node 0 holds
    gateway_region(0)'s region, journaled, its remember store the
    replicated DDataRememberEntitiesStore and its lease an InProcLease
    from the LeaseProvider, and a ReadReplicaCache that publishes each
    wave's totals. make_trace(seed=7) of 2 x RESTORE_WAVES waves, a
    checkpoint after the first half. Legs: remember_ddata (the ORSets
    converge on nodes 1 and 2; node 1 restores a fresh region from a
    copy of node 0's directory without the entity journal and
    entities.log), replica_ddata (node 2's cache, fed by its replicator
    alone, equals node 0's view; publish-to-visible p50/p99), receptionist
    (a ReplicaReader per node registered with the cluster Receptionist;
    node 0 finds all three and reads DD_READS entities of each), lease
    (a rebalance refused while a rival holds the region's lease, then
    done, DD_LEASE_WAVES more waves), a crash of node 2 (the survivors
    take the SBR lease and remove it), metrics (node 0's device probe).
    Returns the fullest inbox of node 0's waves for the K1 row."""
    from akka_tpu_torch.cluster_tools import (ClusterMetricsExtension,
                                              InProcLease, LeaseProvider,
                                              LeaseSettings,
                                              TimeoutSettings)
    from akka_tpu_torch.cluster_tools import metrics as cmetrics
    from akka_tpu_torch.cluster.sbr import LeaseMajority
    from akka_tpu_torch.gateway.replica import ReadReplicaCache
    from akka_tpu_torch.sharding.remember import DDataRememberEntitiesStore
    label = "ddata_paths"
    t_phase = time.perf_counter()
    directory = tempfile.mkdtemp(prefix="chip_smoke_ddata_")
    systems = [ActorSystem.create(f"dd{i}", node_config(
        "tcp", "cluster", cluster=DD_CLUSTER)) for i in range(3)]
    region = fresh = None
    try:
        clusters = [Cluster.get(s) for s in systems]
        for c in clusters:
            c.join(addr_of(systems[0]))
        form_s = dd_wait(lambda: all(
            sum(m.status is MemberStatus.UP for m in c.state.members) == 3
            for c in clusters), "the three nodes are Up")
        stores = [DDataRememberEntitiesStore(s, timeout=ACTOR_TIMEOUT)
                  for s in systems]
        region_lease = LeaseProvider.get(systems[0]).get_lease(
            "ddata-region", "akka.coordination.lease", "region-0")
        region = ddata_region(stores[0], region_lease, device)
        n_shards = region.spec.n_shards
        d0, d1 = (os.path.join(directory, n) for n in ("n0", "n1"))
        region.attach_journal(d0)
        region.attach_entity_journal(d0)
        region.system.warmup()
        caches = [ReadReplicaCache(
            (lambda: region.system._host_step) if i == 0 else (lambda: 0),
            system=s) for i, s in enumerate(systems)]
        seen = Visible(caches[2])
        print(f"{label} setup_s {time.perf_counter() - t_phase} form_s "
              f"{form_s} rows {region.system.capacity}")

        # ---- the waves: K1 once a region step, the fullest inbox kept
        trace = make_trace(seed=7, n_waves=2 * RESTORE_WAVES)
        oracle: dict = {}
        split: dict = {}
        count = Launches()
        t0 = time.perf_counter()
        with StepProbe(region.system, True, *DD_PROBE) as inbox:
            steps = dd_waves(region, trace[:RESTORE_WAVES], oracle,
                             caches[0], seen, count, split)
            t1 = time.perf_counter()
            region.checkpoint()
            ckpt_ms = (time.perf_counter() - t1) * 1e3
            steps += dd_waves(region, trace[RESTORE_WAVES:], oracle,
                              caches[0], seen, count, split)
        waves_s = time.perf_counter() - t0
        n_ask = len(trace) * WAVE_ASKS
        print(f"{label} waves {len(trace)} asks_per_s {n_ask / waves_s} "
              f"steps {steps} checkpoint_ms {ckpt_ms} entities "
              f"{len(oracle)} host_s {json.dumps(split)}")

        # ---- remember_ddata: the ORSets and their rows converge, node 1
        # restores
        allocated = [dict(region._entities[sh]) for sh in range(n_shards)]
        conv_s = dd_wait(lambda: all(
            [st.remembered_rows("counter", str(sh))
             for sh in range(n_shards)] == allocated for st in stores[1:]),
            "the ORSets on nodes 1 and 2 equal node 0's ids, each with "
            "its row")
        print(f"{label} remember_ddata convergence_ms {conv_s * 1e3} "
              f"ids {sum(map(len, allocated))}")
        shutil.copytree(d0, d1)
        for name in ("entities.journal", "entities.log"):
            os.remove(os.path.join(d1, name))
        fresh = ddata_region(stores[1], None, device)
        fresh.attach_journal(d1)
        fresh.system.warmup()
        union = [set().union(*(st.remembered("counter", str(sh))
                               for st in stores)) for sh in range(n_shards)]
        cm.reset_launches()
        t0 = time.perf_counter()
        step = fresh.restore()
        fresh.block_until_ready()
        restore_ms = (time.perf_counter() - t0) * 1e3
        replay = dict(cm.LAUNCHES)
        replayed = int(fresh.restore_timings["replayed_steps"])
        check(replay["ring_reduce"] == replayed > 0, f"{label}: "
              f"{replay['ring_reduce']} K1 launches, one per replayed step "
              f"({replayed})")
        check([set(fresh._entities[sh]) for sh in range(n_shards)] == union,
              f"{label}: the restored region's ids == the ORSets' union")
        names = sorted(oracle)
        check(all(fresh.entity_ref(n).index == region.entity_ref(n).index
                  for n in names), f"{label}: every remembered id at its row")
        rows = np.asarray([fresh.entity_ref(n).row for n in names])
        check(bool(fresh.system.alive[torch.as_tensor(
            rows, device=fresh.system.alive.device)].all()),
              f"{label}: every remembered id holds a live row")
        got = fresh.system.read_state("total", rows)
        check(all(float(g) == oracle[n] for g, n in zip(got, names)),
              f"{label}: every restored total == the host oracle "
              f"({len(names)} entities)")
        launches[f"{label}_restore"] = replay
        print(f"{label} remember_ddata restore_ms {restore_ms} load_ms "
              f"{fresh.restore_timings['load_ms']} replay_ms "
              f"{fresh.restore_timings['replay_ms']} replayed_steps "
              f"{replayed} step {step} launches {replay}")
        del fresh
        fresh = None
        free()

        # ---- replica_ddata: node 2's cache through its replicator alone
        def view(c):
            with c._lock:
                return dict(c._replica)
        want = view(caches[0])
        check({n: t for n, (t, _s) in want.items()} == oracle,
              f"{label}: node 0's view == the oracle")
        vis_s = dd_wait(lambda: all(view(c) == want for c in caches[1:]),
                        "the replica caches on nodes 1 and 2 equal node 0's")
        with seen._lock:
            lat = list(seen.lat)
        check(len(lat) > 0, f"{label}: waves became visible on node 2")
        print(f"{label} replica_ddata publish_to_visible_ms p50 "
              f"{np.percentile(lat, 50) * 1e3} p99 "
              f"{np.percentile(lat, 99) * 1e3} waves_seen {len(lat)} of "
              f"{len(trace)} (host clock) last_wave_to_equal_ms "
              f"{vis_s * 1e3} entries {len(want)}")

        # ---- receptionist: a reader per node, found through the registry
        for i, (s, c) in enumerate(zip(systems, caches)):
            reader = s.actor_of(Props.create(ReplicaReader, c, f"dd{i}"),
                                "replica-reader")
            Receptionist.get(s).register(DD_KEY, reader)
        probe = TestProbe(systems[0])

        def found():
            Receptionist.get(systems[0]).find(DD_KEY, probe.ref)
            return probe.receive_one(ACTOR_TIMEOUT).service_instances
        find_s = dd_wait(lambda: len(found()) == 3,
                         "node 0 finds three replica readers")
        readers = found()
        rng = np.random.default_rng(7)
        picks = [str(x) for x in rng.choice(names, DD_READS, replace=False)]
        answered = set()
        for ref in readers:
            node, rows_ = ask(ref, picks, timeout=ACTOR_TIMEOUT,
                              system=systems[0]).result(ACTOR_TIMEOUT)
            answered.add(node)
            check([(n, t) for n, t, _ in rows_] ==
                  [(n, oracle[n]) for n in picks],
                  f"{label}: {node}'s reader answers the oracle")
        check(answered == {"dd0", "dd1", "dd2"}, f"{label}: every node's "
              f"reader answered ({sorted(answered)})")
        print(f"{label} receptionist find_ms {find_s * 1e3} readers "
              f"{sorted(answered)} reads {DD_READS}")

        # ---- lease: a rebalance needs the region's lease
        rival = InProcLease(LeaseSettings(
            "ddata-region", "rival", TimeoutSettings(
                heartbeat_interval=0.1, heartbeat_timeout=2.0)))
        check(rival.acquire(), f"{label}: the rival takes the lease")
        try:
            region.rebalance(0)
            refused = False
        except RuntimeError as e:
            refused = "lease" in str(e)
        check(refused, f"{label}: a rebalance without the lease raises")
        rival.release()
        old = region.entity_ref(names[0])
        moved = old.shard
        region.rebalance(moved)
        check(region_lease.check_lease(), f"{label}: the region holds its "
              f"lease")
        extra = make_trace(seed=8, n_waves=DD_LEASE_WAVES)
        with StepProbe(region.system, True, *DD_PROBE) as inbox2:
            steps += dd_waves(region, extra, oracle, caches[0], seen, count,
                              {})
        if inbox2.rows > inbox.rows:
            inbox = inbox2
        names = sorted(oracle)
        rows = np.asarray([region.entity_ref(n).row for n in names])
        got = region.system.read_state("total", rows)
        check(all(float(g) == oracle[n] for g, n in zip(got, names)),
              f"{label}: totals == the oracle after the lease's rebalance")
        print(f"{label} lease rebalance refused while held, then shard "
              f"{moved} moved; {DD_LEASE_WAVES} waves")
        count.report(label, "ring_reduce", launches, steps)

        # ---- node 2 crashes: the survivors take the SBR lease
        decisions = dd_decisions(clusters[:2], LeaseMajority, InProcLease)
        crashed = addr_of(systems[2])
        t0 = time.perf_counter()
        systems[2].provider.shutdown_transport()
        systems[2].terminate()
        removed_s = dd_wait(lambda: all(
            crashed not in {m.address_str for m in c.state.members}
            for c in clusters[:2]), "the survivors removed node 2",
            limit=ACTOR_TIMEOUT)
        check(decisions and all(
            owner is not None and owner == st._lease.settings.owner_name
            and crashed in {n.address_str for n in down}
            for st, down, owner in decisions),
              f"{label}: a survivor's lease-majority resolver downed node 2 "
              f"holding the 'ddata-sbr' lease ({decisions})")
        check(systems[2].await_termination(ACTOR_TIMEOUT),
              f"{label}: node 2 terminated")
        print(f"{label} crash_to_removed_s {removed_s} members "
              f"{[len(c.state.members) for c in clusters[:2]]} sbr_lease "
              f"{decisions[0][2]}")

        dd_metrics(systems[0], ClusterMetricsExtension, cmetrics)
        region_lease.release()
        check(inbox.rows > 0 and int(inbox.inputs[0][3].sum()) > 0,
              f"{label}: K1's input carries messages ({inbox.rows} rows)")
        print(f"{label} kernel_input live_rows {inbox.rows} of "
              f"{inbox.inputs[0][0].shape[0]}")
        out = {label: ("K1", inbox.inputs, SLOTS)}
    finally:
        for s in systems:
            s.terminate()
        shutil.rmtree(directory, ignore_errors=True)
    for s in systems:
        check(s.await_termination(ACTOR_TIMEOUT),
              f"{label}: {s.name} terminated")
    del region, fresh, systems
    free()
    print(f"{label} phase_s {time.perf_counter() - t_phase}")
    return out


def dd_decisions(clusters, strategy_class, lease_class) -> list:
    """Wraps each cluster's split-brain resolver strategy (which must be
    `strategy_class`): every decision that downs nodes is recorded as
    (strategy, down nodes, the owner of the 'ddata-sbr' lease in
    `lease_class`'s table as the decision is made)."""
    decisions = []
    for c in clusters:
        st = c.sbr.cell.actor.strategy
        check(isinstance(st, strategy_class), f"ddata_paths: the resolver "
              f"is {type(st).__name__}, not {strategy_class.__name__}")

        def recorded(*args, st=st, decide=st.decide):
            d = decide(*args)
            if d.down_nodes:
                with lease_class._lock:
                    rec = lease_class._table.get("ddata-sbr")
                decisions.append((st, list(d.down_nodes),
                                  rec.owner if rec else None))
            return d
        st.decide = recorded
    return decisions


def dd_metrics(system, extension, metrics) -> None:
    """ClusterMetricsExtension with the device probe on: the sampled
    memory used is above 0 and the limit is the card's total memory."""
    ext = extension.get(system)
    self_addr = str(system.provider.default_address)
    total = torch.cuda.get_device_properties(0).total_memory

    def sampled():
        nm = ext.node_metrics.get(self_addr)
        return nm is not None and nm.metric(metrics.DEVICE_MEMORY_USED) \
            is not None
    dd_wait(sampled, "the device probe sampled node 0")
    nm = ext.node_metrics[self_addr]
    used = nm.metric(metrics.DEVICE_MEMORY_USED).value
    limit = nm.metric(metrics.DEVICE_MEMORY_MAX).value
    check(used > 0, f"ddata_paths: device memory used {used} > 0")
    check(limit == total, f"ddata_paths: the limit {limit} == the card's "
          f"total memory {total}")
    print(f"ddata_paths metrics device_memory_used {used} "
          f"device_memory_max {limit}")


def ddata_phase_only(runs: int, smi: str) -> int:
    """`python3 chip_smoke.py --ddata-phase N`: ddata_paths alone, N times
    in one process, every check as in the whole run and K1 held to its
    plain version on each run's fullest inbox. The last line is
    {"ddata_phase_s": [...]}."""
    lib = cm.build()
    times = []
    for r in range(runs):
        launches: Dict[str, dict] = {}
        t0 = time.perf_counter()
        flat = ddata_paths(launches)
        times.append(time.perf_counter() - t0)
        check(times[-1] < DD_PHASE_S, f"ddata_paths run {r}: {times[-1]} "
              f"s, more than {DD_PHASE_S}")
        for label, (k, inputs, slots) in flat.items():
            row = kernel_rows(label, *inputs, lib, kernels=(k,),
                              slots=slots)[k]
            print(f"ddata_phase_run {r} {k} {json.dumps(row)}")
        print(f"ddata_phase_run {r} ddata_phase_s {times[-1]} "
              f"k1_launches {launches['ddata_paths']['ring_reduce']}")
    print(smi)
    print(json.dumps({"ddata_phase_s": times}))
    return 0


# --------------------------- host sharding in front of the device region
SH_PHASE_S = 60.0           # the phase's limit
SH_SEED, SH_ENTITIES = 11, 2048     # Account ids, seeded traffic
SH_ROUNDS, SH_CONC = 16, 256        # rounds of concurrent asks
SH_LEAVE_AFTER = 8          # rounds before node 1 leaves
SH_HOST_SHARDS = 64         # the Account type's host shards
SH_FRONT = ServiceKey("device-front")
SH_ACCOUNT = EntityTypeKey("Account")
# the nodes' membership, with the replicator at the fast settings
SH_CLUSTER = {**FAST_MEMBERSHIP, "distributed-data": DD_REPLICATOR}


def sharding_region(system, device: str = "cuda"):
    """gateway_region(0)'s full-width counter region (K1), made through
    the typed facade's device entry point."""
    return ClusterShardingTyped.get(system).init_device(DeviceEntity(
        "counter", counter_behavior(PAYLOAD_W), n_shards=256,
        entities_per_shard=4096, n_devices=1, spare_blocks=2,
        mailbox_slots=0), device=device)


class DeviceFront(Actor):
    """Node 0's front of the device region: ("add", id, v, reply_to)
    resolves the id's row and pipes the batcher's reply, the row's total
    after the add, to reply_to (no dispatcher thread waits)."""

    def __init__(self, region, batcher):
        super().__init__()
        self.region, self.batcher = region, batcher

    def receive(self, message):
        _, eid, v, reply_to = message
        ref = self.region.entity_ref(eid)
        pipe(then(self.batcher.submit(ref.shard, ref.index,
                                      [v, 0.0, 0.0, 0.0]),
                  lambda r: float(r[0])), reply_to, self.self_ref)


def account(entity_id: str, front):
    """The Account entity (typed): ("add", v, reply_to) asks the front
    with its own reply ref (ctx.ask pipes the reply to the entity) and
    answers ("total", id, total), or ("failed", id, error)."""
    def on_message(ctx, msg):
        if msg[0] == "add":
            _, v, reply_to = msg
            ctx.ask(front, lambda r: ("add", entity_id, v, r),
                    lambda rep, err: ("added", rep, err, reply_to),
                    timeout=ACTOR_TIMEOUT)
        elif msg[0] == "added":
            _, total, err, reply_to = msg
            reply_to.tell(("total", entity_id, total) if err is None
                          else ("failed", entity_id, repr(err)))
        return Behaviors.same
    return Behaviors.receive(on_message)


def region_states(regions, probes) -> list:
    """Each host region's (shard count, ids), through
    GetShardRegionState; None for a region that did not answer."""
    out = []
    for r, p in zip(regions, probes):
        r.tell(GetShardRegionState(), p.ref)
        try:
            st = p.receive_one(ACTOR_TIMEOUT)
        except AssertionError:
            out.append(None)
            continue
        out.append((len(st.shards),
                    {e for sh in st.shards for e in sh.entity_ids}))
    return out


def sh_settle(regions, probes, ids, label: str) -> list:
    """StartEntity through node 0's region for every id not yet hosted,
    at each poll (a shard a rebalance handed off comes back on demand),
    until the regions host them all with shard counts within one of each
    other, so the coordinator has nothing to move while asks are in
    flight. One id a host shard goes first: shards allocated before
    sh1's region registered then move with one entity each. Returns each
    region's ids."""
    got = []

    def balanced(want):
        hosted = set().union(*(e for _, e in got)) if got else set()
        for eid in want:
            if eid not in hosted:
                regions[0].tell(StartEntity(eid))
        got[:] = [g or (0, set()) for g in region_states(regions,
                                                          probes)]
        counts = [c for c, _ in got]
        return set().union(*(e for _, e in got)) >= set(want) and \
            max(counts) - min(counts) <= 1
    extract = make_default_extract_shard_id(SH_HOST_SHARDS)
    firsts = {}
    for eid in ids:
        firsts.setdefault(extract(StartEntity(eid)), eid)
    for want in (sorted(firsts.values()), ids):
        dd_wait(lambda: balanced(want), "the Account ids start, balanced",
                limit=30.0, label=label)
    return [e for _, e in got]


def sh_rounds(shardings, rounds: int, rng, oracle: dict, lat: list) -> float:
    """`rounds` rounds of SH_CONC concurrent EntityRef.ask adds, a
    round's ids distinct, dealt in turn to the nodes' entity_ref_for;
    every reply held to the oracle's running total. Returns the wall
    seconds."""
    t0 = time.perf_counter()
    for _ in range(rounds):
        picks = rng.choice(SH_ENTITIES, SH_CONC, replace=False)
        vals = rng.integers(1, 100, SH_CONC).astype(np.float64)
        futs = []
        for k, (i, v) in enumerate(zip(picks, vals)):
            eid = f"acct-{int(i)}"
            ref = shardings[k % len(shardings)].entity_ref_for(SH_ACCOUNT,
                                                               eid)
            t = time.perf_counter()
            f = ref.ask(lambda r, v=float(v): ("add", v, r),
                        timeout=ACTOR_TIMEOUT)
            f.add_done_callback(
                lambda _f, t=t: lat.append(time.perf_counter() - t))
            futs.append((eid, float(v), f))
        for eid, v, f in futs:
            oracle[eid] = oracle.get(eid, 0.0) + v
            rep = f.result(ACTOR_TIMEOUT)
            check(rep == ("total", eid, oracle[eid]), f"sharding_paths: "
                  f"{rep} == the oracle's {oracle[eid]} for {eid}")
    return time.perf_counter() - t0


def sharding_paths(launches: dict, device: str = "cuda") -> dict:
    """sharding_paths (ROADMAP A12.4): two provider = cluster nodes over
    TCP loopback (FAST_MEMBERSHIP, the replicator at the fast settings);
    sh0 joins first, so it is the oldest and holds the coordinator.
    ClusterShardingTyped.init_device on sh0 gives gateway_region(0)'s
    full-width counter region (K1) behind an AskBatcher and a DeviceFront
    registered with the cluster Receptionist. Account entities (typed,
    SH_HOST_SHARDS host shards, remember-entities in the ddata store) run
    on both nodes, each owning one device row; an add goes EntityRef.ask
    -> Account (on either node) -> ctx.ask of the front -> the batcher,
    and the Account answers with the row's total. SH_ROUNDS rounds of
    SH_CONC asks over SH_ENTITIES ids (seed SH_SEED), half through each
    node's entity_ref_for, every reply held to a host oracle. After
    SH_LEAVE_AFTER rounds sh1 leaves and terminates; one StartEntity per
    shard it hosted brings the shards home to sh0, whose Shards restart
    the rest of their remembered ids (hand-off s: leave to every id on
    sh0); the remaining rounds run from sh0 alone. The device rows of
    every touched id equal the oracle. Returns the fullest inbox for the
    K1 row."""
    from akka_tpu_torch.sharding import ClusterShardingSettings, Entity
    from akka_tpu_torch.sharding.remember import DDataRememberEntitiesStore
    from akka_tpu_torch.testkit.sharding import region_entity_ids
    label = "sharding_paths"
    t_phase = time.perf_counter()
    systems = [ActorSystem.create(f"sh{i}", node_config(
        "tcp", "cluster", cluster=SH_CLUSTER)) for i in range(2)]
    region = batcher = None
    try:
        clusters = [Cluster.get(s) for s in systems]
        clusters[0].join(addr_of(systems[0]))
        dd_wait(lambda: any(m.status is MemberStatus.UP
                            for m in clusters[0].state.members),
                "sh0 is Up", label=label)
        clusters[1].join(addr_of(systems[0]))
        form_s = dd_wait(lambda: all(
            sum(m.status is MemberStatus.UP for m in c.state.members) == 2
            for c in clusters), "both nodes are Up", label=label)
        region = sharding_region(systems[0], device)
        region.system.warmup()
        batcher = AskBatcher(region, max_batch=SH_CONC)
        front = systems[0].actor_of(Props.create(DeviceFront, region,
                                                 batcher), "front")
        Receptionist.get(systems[0]).register(SH_FRONT, front)
        # the reference's fast intervals (tests/test_sharding.py): a
        # shard allocated before sh1's region registered moves within
        # seconds, three at a time
        settings = ClusterShardingSettings(
            number_of_shards=SH_HOST_SHARDS, retry_interval=0.1,
            rebalance_interval=0.3, remember_entities=True,
            remember_entities_store="ddata")
        shardings, regions, probes = [], [], []
        for s in systems:
            probe = TestProbe(s)

            def fronts(s=s, probe=probe):
                Receptionist.get(s).find(SH_FRONT, probe.ref)
                return probe.receive_one(ACTOR_TIMEOUT).service_instances
            dd_wait(lambda: len(fronts()) == 1, f"{s.name} finds the front",
                    label=label)
            (ref,) = fronts()
            sh = ClusterShardingTyped.get(s)
            regions.append(sh.init(Entity(
                SH_ACCOUNT, lambda ctx, ref=ref: account(ctx.entity_id, ref),
                settings=settings)))
            shardings.append(sh)
            probes.append(probe)
        ids = [f"acct-{i}" for i in range(SH_ENTITIES)]
        t0 = time.perf_counter()
        hosted = sh_settle(regions, probes, ids, label)
        settle_s = time.perf_counter() - t0
        check(all(hosted), f"{label}: both nodes host Accounts")
        print(f"{label} setup_s {time.perf_counter() - t_phase} form_s "
              f"{form_s} settle_s {settle_s} rows {region.system.capacity} "
              f"accounts_by_node {[len(h) for h in hosted]}")

        rng = np.random.default_rng(SH_SEED)
        oracle: dict = {}
        count = Launches()
        steps = 0
        inbox = None
        for leg, (nodes, rounds) in enumerate(
                ((shardings, SH_LEAVE_AFTER),
                 (shardings[:1], SH_ROUNDS - SH_LEAVE_AFTER))):
            lat: list = []
            s0 = region.system._host_step
            with StepProbe(region.system, True, *DD_PROBE) as probe_in:
                wall = count(lambda: sh_rounds(nodes, rounds, rng, oracle,
                                               lat))
            steps += region.system._host_step - s0
            if inbox is None or probe_in.rows > inbox.rows:
                inbox = probe_in
            n_ask = rounds * SH_CONC
            check(len(lat) == n_ask, f"{label}: every ask resolved")
            tag = ("two_nodes", "one_node")[leg]
            print(f"{label} {tag} rounds {rounds} asks_per_s "
                  f"{n_ask / wall} ask p50_ms "
                  f"{np.percentile(lat, 50) * 1e3} p99_ms "
                  f"{np.percentile(lat, 99) * 1e3} region_steps "
                  f"{region.system._host_step - s0} busy_ms "
                  f"{probe_in.busy_ms} (host clock; CUDA events around "
                  f"each run)")
            if leg:
                break
            # ---- the hand-off: sh1 leaves, its shards come home to sh0
            on_1 = region_entity_ids(regions[1], probes[1], ACTOR_TIMEOUT)
            check(bool(on_1), f"{label}: sh1 hosts Accounts")
            store = DDataRememberEntitiesStore(systems[0],
                                               timeout=ACTOR_TIMEOUT)

            def remembered():
                return set().union(*(store.remembered("Account", str(sh))
                                     for sh in range(SH_HOST_SHARDS)))
            dd_wait(lambda: remembered() >= set(oracle),
                    "sh0's replica remembers every asked id", label=label)
            rows = {}
            for sh in range(SH_HOST_SHARDS):
                rows.update(store.remembered_rows("Account", str(sh)))
            check(set(rows.values()) == {None}, f"{label}: host ids have "
                  f"no device row in the store")
            leaving = addr_of(systems[1])
            t0 = time.perf_counter()
            clusters[1].leave(leaving)
            dd_wait(lambda: leaving not in {
                m.address_str for m in clusters[0].state.members},
                "sh0 removed sh1", label=label)
            removed_s = time.perf_counter() - t0
            systems[1].terminate()
            check(systems[1].await_termination(ACTOR_TIMEOUT),
                  f"{label}: sh1 terminated")
            terminated_s = time.perf_counter() - t0
            extract = make_default_extract_shard_id(SH_HOST_SHARDS)
            kicked = {}
            for eid in sorted(on_1):
                kicked.setdefault(extract(StartEntity(eid)), eid)

            def home():
                # again at each poll: until the coordinator has freed
                # sh1's shards, a StartEntity may go to the dead region
                for eid in kicked.values():
                    regions[0].tell(StartEntity(eid))
                st = region_states(regions[:1], probes[:1])[0]
                return st is not None and st[0] == SH_HOST_SHARDS and \
                    st[1] >= on_1
            dd_wait(home, "every shard's home is sh0 and every id sh1 "
                    "hosted runs there", label=label)
            handoff_s = time.perf_counter() - t0
            lost = (on_1 & remembered()) - region_entity_ids(
                regions[0], probes[0], ACTOR_TIMEOUT)
            check(not lost, f"{label}: remembered ids of sh1 run on sh0 "
                  f"({sorted(lost)[:4]})")
            print(f"{label} handoff_s {handoff_s} leave_to_removed_s "
                  f"{removed_s} leave_to_terminated_s {terminated_s} "
                  f"shards_kicked {len(kicked)} "
                  f"remembered_restarts {len(on_1) - len(kicked)} of "
                  f"{len(on_1)} ids on sh1 (host clock)")
        count.report(label, "ring_reduce", launches, steps)
        names = sorted(oracle)
        rows = np.asarray([region.entity_ref(n).row for n in names])
        got = region.system.read_state("total", rows)
        check(all(float(g) == oracle[n] for g, n in zip(got, names)),
              f"{label}: every touched device row == the oracle "
              f"({len(names)} entities)")
        check(batcher.stats()["asks"] == SH_ROUNDS * SH_CONC,
              f"{label}: one batcher ask per EntityRef.ask")
        check(inbox.rows > 0 and int(inbox.inputs[0][3].sum()) > 0,
              f"{label}: K1's input carries messages ({inbox.rows} rows)")
        print(f"{label} kernel_input live_rows {inbox.rows} of "
              f"{inbox.inputs[0][0].shape[0]} batches "
              f"{batcher.stats()['batches']}")
        out = {label: ("K1", inbox.inputs, SLOTS)}
    finally:
        if batcher is not None:
            batcher.close()
        for s in systems:
            s.terminate()
    for s in systems:
        check(s.await_termination(ACTOR_TIMEOUT),
              f"{label}: {s.name} terminated")
    del region, batcher, systems
    free()
    print(f"{label} phase_s {time.perf_counter() - t_phase}")
    return out


def sharding_phase_only(runs: int, smi: str) -> int:
    """`python3 chip_smoke.py --sharding-phase N`: sharding_paths alone, N
    times in one process, every check as in the whole run and K1 held to
    its plain version on each run's fullest inbox. The last line is
    {"sharding_phase_s": [...]}."""
    lib = cm.build()
    times = []
    for r in range(runs):
        launches: Dict[str, dict] = {}
        t0 = time.perf_counter()
        flat = sharding_paths(launches)
        times.append(time.perf_counter() - t0)
        check(times[-1] < SH_PHASE_S, f"sharding_paths run {r}: "
              f"{times[-1]} s, more than {SH_PHASE_S}")
        for label, (k, inputs, slots) in flat.items():
            row = kernel_rows(label, *inputs, lib, kernels=(k,),
                              slots=slots)[k]
            print(f"sharding_phase_run {r} {k} {json.dumps(row)}")
        print(f"sharding_phase_run {r} sharding_phase_s {times[-1]} "
              f"k1_launches {launches['sharding_paths']['ring_reduce']}")
    print(smi)
    print(json.dumps({"sharding_phase_s": times}))
    return 0


# ------------------------------------------- the stream DSL on the card
ST_PHASE_S = 60.0           # the phase's limit
ST_CONC = 4                 # stream_region's waves in flight (map_async)
ST_CUT = 8                  # stream_region's cut run: replies before the cut
ST_ONE_PAR = 8              # stream_ask's single-ref Flow.ask parallelism
ST_ONE_ASKS = 1024          # asks of the single-ref leg
ST_ASK_SEED, ST_WAVE_SEED = 29, 17
# the single-ref leg's dispatcher: as many bounded slots and emissions a
# row as the Flow.ask's parallelism, so that every ask in flight lands in
# a slot of one step and gets its own reply (K2)
ST_ONE_DISPATCHER = {"type": "tpu-batched", "capacity": 4096,
                     "payload-width": PAYLOAD_W, "mailbox-slots": ST_ONE_PAR,
                     "out-degree": ST_ONE_PAR, "spill-capacity": 0,
                     "promise-rows": 256, "host-inbox": 4096,
                     "pipeline-depth": 4}


@behavior("ask_log", {"total": ((), torch.float32)}, inbox="slots")
def ask_log(state, mailbox, ctx):
    """Adds each message's payload[0] to the total in slot (arrival)
    order and replies to each message's reply row with the total after
    it: one emission a slot."""
    n, slots = mailbox.valid.shape
    dev = ctx.actor_id.device
    total = state["total"]
    dst = torch.full((n, slots), -1, dtype=torch.int32, device=dev)
    pay = torch.zeros((n, slots, mailbox.payload.shape[-1]), device=dev)
    for j in range(slots):
        v = mailbox.valid[:, j]
        total = torch.where(v, total + mailbox.payload[:, j, 0], total)
        dst[:, j] = torch.where(v, reply_dst(mailbox.payload[:, j]), -1)
        pay[:, j, 0] = total
    return {"total": total}, Emit(dst=dst, payload=pay, valid=dst >= 0,
                                  type=torch.zeros_like(dst))


def wave_entry(backend):
    """A stream element (one wave of (entity, add) pairs) staged through
    the gateway's async wave entry, RegionBackend.ask_many_async, on the
    calling thread; the Future completes on the scheduler thread at the
    wave's resolve boundary with the outcomes in the wave's order."""
    def wave(asks) -> Future:
        fut: Future = Future()
        backend.ask_many_async([n for n, _ in asks], [v for _, v in asks],
                               None, lambda out, _seqs: fut.set_result(out))
        return fut
    return wave


def hold_waves(label: str, trace, replies, oracle: dict) -> None:
    """Each wave's replies, in element order, against the oracle's running
    totals in staging order (which it advances)."""
    check(len(replies) == len(trace), f"{label}: {len(replies)} of "
          f"{len(trace)} waves answered")
    for asks, out in zip(trace, replies):
        for (n, v), o in zip(asks, out):
            check(not isinstance(o, BaseException), f"{label}: {o!r}")
            oracle[n] = oracle.get(n, 0.0) + v
            check(o == oracle[n], f"{label}: reply {o} == oracle "
                  f"{oracle[n]} for {n}")


def stream_region(system, launches: dict, flat: dict) -> None:
    """stream_region: gateway_region(0)'s full-width counter region (K1)
    behind RegionBackend(continuous=True, pipeline_depth=4); a
    Source.from_iterable of make_trace's WAVES + 2 waves of 256 adds goes
    through map_async(ST_CONC, wave_entry) into Sink.fold. The replies
    must come out in element order, each equal to the oracle's running
    total. A second run of WAVES waves goes through
    KillSwitches.single() before the map_async; the switch is shut down
    once ST_CUT waves are answered: every wave that passed it is
    answered, and the region's totals hold exactly those waves."""
    label = "stream_region"
    region = gateway_region(0)
    region.system.warmup()
    backend = RegionBackend(region, continuous=True, pipeline_depth=4)
    wave = wave_entry(backend)
    oracle: dict = {}
    try:
        trace = make_trace(ST_WAVE_SEED)
        count = Launches()
        s0 = region.system._host_step

        def whole():
            out = st.Source.from_iterable(trace) \
                .map_async(ST_CONC, wave) \
                .run_with(st.Sink.fold([], lambda acc, o: acc + [o]),
                          system).result(ACTOR_TIMEOUT)
            check(backend.batcher.quiesce(ACTOR_TIMEOUT),
                  f"{label}: quiesce")
            return out
        with StepProbe(region.system, True, *DD_PROBE) as probe:
            t0 = time.perf_counter()
            replies = count(whole)
            wall = time.perf_counter() - t0
        steps = region.system._host_step - s0
        hold_waves(label, trace, replies, oracle)
        adds = sum(len(w) for w in trace)
        print(f"{label} waves {len(trace)} waves_per_s {len(trace) / wall} "
              f"adds_per_s {adds / wall} steps {steps} busy_ms "
              f"{probe.busy_ms} wall_ms {wall * 1e3} (host clock; CUDA "
              f"events around each run)")

        # the cut: the switch sits before the map_async, so every wave
        # that passed it is staged and answered before the stream ends
        cut = make_trace(ST_WAVE_SEED + 1, WAVES)
        got, enough = [], threading.Event()

        def on_reply(out):
            got.append(out)
            if len(got) >= ST_CUT:
                enough.set()

        def cut_run():
            switch, done = st.Source.from_iterable(cut) \
                .via_mat(st.KillSwitches.single(), st.Keep.right) \
                .map_async(ST_CONC, wave) \
                .to_mat(st.Sink.foreach(on_reply), st.Keep.both) \
                .run(system)
            check(enough.wait(ACTOR_TIMEOUT), f"{label}: {ST_CUT} waves "
                  f"answered before the cut")
            at_cut = len(got)
            switch.shutdown()
            done.result(ACTOR_TIMEOUT)
            check(backend.batcher.quiesce(ACTOR_TIMEOUT),
                  f"{label}: quiesce after the cut")
            return at_cut
        s1 = region.system._host_step
        at_cut = count(cut_run)
        steps += region.system._host_step - s1
        passed = len(got)
        check(ST_CUT <= at_cut <= passed < len(cut), f"{label}: the cut "
              f"ends the stream ({at_cut} answered at the cut, {passed} "
              f"passed the switch, of {len(cut)})")
        hold_waves(label + " cut", cut[:passed], got, oracle)
        names = sorted(oracle)
        rows = np.asarray([region.entity_ref(n).row for n in names])
        totals = region.system.read_state("total", rows)
        check(all(float(t) == oracle[n] for t, n in zip(totals, names)),
              f"{label}: every touched row == the oracle ({len(names)} "
              f"entities)")
        check(backend.sum_all() == sum(oracle.values()), f"{label}: "
              f"sum_all == the oracle's sum (no wave after the cut)")
        print(f"{label} cut answered_at_cut {at_cut} passed {passed} of "
              f"{len(cut)}")
        count.report(label, "ring_reduce", launches, steps)
        check(probe.rows > 0 and int(probe.inputs[0][3].sum()) > 0,
              f"{label}: K1's input carries messages ({probe.rows} rows)")
        print(f"{label} kernel_input live_rows {probe.rows} of "
              f"{probe.inputs[0][0].shape[0]}")
        flat[label] = ("K1", probe.inputs, SLOTS)
    finally:
        backend.close()
    del region, backend
    free()


def stream_ask(system, launches: dict, flat: dict) -> None:
    """stream_ask: actor_ask's block (ASK_ACTORS slots counters on a
    tpu-batched dispatcher of 2^20 rows, ASK_SLOTS bounded slots: K2)
    asked from a stream: ASK_ROUNDS * ASK_CONC elements (row, add)
    through map_async(ASK_CONC, tell the add, then ask(refs[row], GET)),
    Flow.ask's own body over many refs; any ASK_ACTORS consecutive
    elements name distinct rows, so a row has one ask in flight. Then
    Flow().ask(ST_ONE_PAR, ref) of ST_ONE_ASKS adds on one ref (ask_log,
    on a dispatcher with ST_ONE_PAR slots and emissions a row): each
    reply is the running total after its add. Every reply equals the
    oracle, and K2 launches once a step of each dispatcher. One more
    untimed window of each (a sync a step) gives K2's inputs at both
    shapes: ASK_SLOTS slots (stream_ask) and ST_ONE_PAR (stream_ask_one)."""
    label = "stream_ask"
    block = system.actor_of(device_props(
        slots_counter, n=ASK_ACTORS,
        dispatcher="akka.actor.stream-ask-dispatcher"), "stream-counters")
    refs = [block[i] for i in range(ASK_ACTORS)]
    one = system.actor_of(device_props(
        ask_log, n=1, dispatcher="akka.actor.stream-one-dispatcher"),
        "stream-log")
    h = get_handle(system, "akka.actor.stream-ask-dispatcher")
    h1 = get_handle(system, "akka.actor.stream-one-dispatcher")
    check(h.runtime.spill_cap == 0 and h1.runtime.spill_cap == 0,
          f"{label}: bounded slots mailboxes (K2)")
    rng = np.random.default_rng(ST_ASK_SEED)
    n_el = ASK_ROUNDS * ASK_CONC
    rows = rng.permutation(ASK_ACTORS)[np.arange(n_el) % ASK_ACTORS]
    vals = rng.integers(1, 100, n_el).astype(np.float64)
    oracle = np.zeros(ASK_ACTORS)
    want = []
    for r, v in zip(rows, vals):
        oracle[r] += v
        want.append(oracle[r])
    one_vals = rng.integers(1, 100, ST_ONE_ASKS).astype(np.float64)
    one_more = rng.integers(1, 100, ST_ONE_PAR * 4).astype(np.float64)
    lat: list = []

    def ask_one(e):
        r, v = e
        refs[r].tell((ADD, [v]))
        t = time.perf_counter()
        f = ask(refs[r], (GET, [0.0]), ACTOR_TIMEOUT)
        f.add_done_callback(
            lambda _f, t=t: lat.append(time.perf_counter() - t))
        return f

    def one_ref(vals):
        return st.Source.from_iterable([(ADD, [v]) for v in vals]) \
            .via(st.Flow().ask(ST_ONE_PAR, one, ACTOR_TIMEOUT)) \
            .run_with(st.Sink.seq(), system).result(ACTOR_TIMEOUT * 4)

    def drive():
        with StepProbe(h.runtime) as probe:
            t0 = time.perf_counter()
            got = st.Source.from_iterable(
                list(zip(rows.tolist(), vals.tolist()))) \
                .map_async(ASK_CONC, ask_one) \
                .run_with(st.Sink.seq(), system).result(ACTOR_TIMEOUT * 4)
            wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        got1 = one_ref(one_vals)
        wall1 = time.perf_counter() - t0
        # K2's inputs: the fullest inbox of one more window of asks on
        # each dispatcher
        with StepProbe(h.runtime, live=True) as live:
            extra = rng.permutation(ASK_ACTORS)[:ASK_CONC]
            st.Source.from_iterable([(int(r), 1.0) for r in extra]) \
                .map_async(ASK_CONC, ask_one) \
                .run_with(st.Sink.ignore(), system).result(ACTOR_TIMEOUT)
            oracle[extra] += 1.0
        with StepProbe(h1.runtime, live=True) as live1:
            got1 += one_ref(one_more)
        return got, wall, got1, wall1, probe, live, live1

    (got, wall, got1, wall1, probe, live, live1), steps, count = \
        handles_window([h, h1], drive)
    bad = [(i, g[0], w) for i, (g, w) in enumerate(zip(got, want))
           if g[0] != w]
    check(len(got) == n_el and not bad, f"{label}: every reply equals the "
          f"oracle, in element order ({bad[:4]})")
    run = np.cumsum(np.concatenate([one_vals, one_more]))
    bad1 = [(i, g[0], w) for i, (g, w) in enumerate(zip(got1, run))
            if g[0] != w]
    check(len(got1) == len(run) and not bad1, f"{label}: Flow.ask on "
          f"one ref: every reply is the running total ({bad1[:4]})")
    check(np.array_equal(block.read_state("count"),
                         oracle.astype(np.float32)),
          f"{label}: every counter equals the oracle")
    for hh in (h, h1):
        check(hh.ask_pool_stats()["in_flight"] == 0,
              f"{label}: no ask left in flight")
    print(f"{label} asks_per_s {n_el / wall} ask {json.dumps(pcts_us(lat))} "
          f"steps {steps[0]} busy_ms {probe.busy_ms} wall_ms {wall * 1e3}")
    print(f"{label} one_ref asks_per_s {ST_ONE_ASKS / wall1} parallelism "
          f"{ST_ONE_PAR} steps {steps[1]}")
    count.report(label, "ring_slots", launches, sum(steps))
    for key, lv, slots in ((label, live, ASK_SLOTS),
                           (label + "_one", live1, ST_ONE_PAR)):
        inputs, n = lv.inputs
        check(lv.rows > 0 and int(inputs[3].sum()) > 0,
              f"{key}: K2's input carries messages ({lv.rows} rows)")
        print(f"{key} kernel_input live_rows {lv.rows} of "
              f"{inputs[0].shape[0]} slots {slots}")
        flat[key] = ("K2", (inputs, n), slots)


def stream_pipeline(system, launches: dict, device: str = "cuda") -> None:
    """stream_pipeline: device_pipeline's chain over its PIPE_CHUNKS chunks
    as Source.from_iterable(chunks).via(pipe.as_flow()) into Sink.seq:
    every (out, mask) and the final carry (the captured step's carry
    buffer after the last element) bit-equal to pipe.run(chunks) of the
    same chain on the same card. Prints ms per chunk of the stream and of
    run() (host clock, a sync after each), beside device_pipeline's."""
    label = "stream_pipeline"
    chunks = pipe_chunks(device)
    flow_pipe, run_pipe = pipe_chain(device), pipe_chain(device)
    count = Launches()

    def through():
        out = st.Source.from_iterable(chunks).via(flow_pipe.as_flow()) \
            .run_with(st.Sink.seq(), system).result(ACTOR_TIMEOUT)
        torch.cuda.synchronize()
        return out

    def ran():
        res = run_pipe.run(chunks)
        torch.cuda.synchronize()
        return res
    t0 = time.perf_counter()
    out = count(through)     # the first element captures
    first_s = time.perf_counter() - t0
    ref = ran()
    times = {"stream": [], "run": []}
    for _ in range(PAIRS):
        for mode, fn in (("stream", through), ("run", ran)):
            t0 = time.perf_counter()
            res = count(fn)
            times[mode].append((time.perf_counter() - t0) * 1e3
                               / PIPE_CHUNKS)
            if mode == "stream":
                out = res
    step = flow_pipe.compile()
    if device == "cuda":
        check(step.captures == 1, f"{label}: one capture "
              f"({step.captures})")
        (slot,) = step.slots.values()
        carry = slot.carry
    else:
        carry = None
    ro, rm, (rc, rx) = ref
    check(len(out) == PIPE_CHUNKS, f"{label}: {len(out)} elements")
    check(all(torch.equal(o, ro[i]) and torch.equal(m, rm[i])
              for i, (o, m) in enumerate(out)),
          f"{label}: every (out, mask) bit-equal to run()")
    if carry is not None:
        check(torch.equal(carry[0], rc) and torch.equal(carry[1], rx),
              f"{label}: the final carry bit-equal to run()'s")
    for mode, ts in times.items():
        print(f"{label} {mode} ms_per_chunk {float(np.median(ts))} pairs "
              f"{ts}")
    print(f"{label} first_run_s {first_s} (the capture included)")
    count.report(label, None, launches)
    del chunks, flow_pipe, run_pipe, out, ref
    free()


def stream_paths(launches: dict, device: str = "cuda") -> dict:
    """stream_paths (ROADMAP A12.5, the core): stream_region,
    stream_ask and stream_pipeline in one ActorSystem, whose default
    dispatcher hosts the streams' interpreter actors; returns the K1 and
    K2 delivery inputs by label."""
    extra = {"device": "cpu"} if device == "cpu" else {}
    cfg = {"akka": {"stdout-loglevel": "OFF", "log-dead-letters": 0,
                    "actor": {
                        "stream-ask-dispatcher": {**ASK_DISPATCHER,
                                                  **extra},
                        "stream-one-dispatcher": {**ST_ONE_DISPATCHER,
                                                  **extra}}}}
    flat: dict = {}
    # what earlier phases left in the process: its threads and the
    # objects the collector tracks
    print(f"stream_paths threads_at_start {threading.active_count()} "
          f"gc_objects {len(gc.get_objects())}")
    t_phase = time.perf_counter()
    system = ActorSystem.create("stream-paths", cfg)
    try:
        for label, leg in (("stream_region", stream_region),
                           ("stream_ask", stream_ask)):
            t0 = time.perf_counter()
            leg(system, launches, flat)
            print(f"{label} phase_s {time.perf_counter() - t0}")
        t0 = time.perf_counter()
        stream_pipeline(system, launches, device)
        print(f"stream_pipeline phase_s {time.perf_counter() - t0}")
    finally:
        system.terminate()
        check(system.await_termination(ACTOR_TIMEOUT),
              "stream_paths: the system terminated")
    del system
    free()
    print(f"stream_paths phase_s {time.perf_counter() - t_phase}")
    return flat


def stream_phase_only(runs: int, smi: str) -> int:
    """`python3 chip_smoke.py --stream-phase N`: stream_paths alone, N
    times in one process, every check as in the whole run and K1 and K2
    held to their plain versions on each run's fullest inboxes. The last
    line is {"stream_phase_s": [...]}."""
    lib = cm.build()
    times = []
    for r in range(runs):
        launches: Dict[str, dict] = {}
        t0 = time.perf_counter()
        flat = stream_paths(launches)
        times.append(time.perf_counter() - t0)
        check(times[-1] < ST_PHASE_S, f"stream_paths run {r}: "
              f"{times[-1]} s, more than {ST_PHASE_S}")
        for label, (k, (inputs, n), slots) in flat.items():
            row = kernel_rows(label, inputs, n, lib, kernels=(k,),
                              slots=slots)[k]
            print(f"stream_phase_run {r} {label} {k} {json.dumps(row)}")
        print(f"stream_phase_run {r} stream_phase_s {times[-1]} launches "
              f"{json.dumps(launches)}")
    print(smi)
    print(json.dumps({"stream_phase_s": times}))
    return 0



# ------------------------- io/ and the rest of stream/ on the card
SI_PHASE_S = 60.0           # the phase's limit
SI_CONC = 4                 # waves in flight through map_async
SI_GW_LEGS = (("stream", 1), ("evloop", 1), ("evloop", 2), ("stream", 2))
SI_REF_WAVES, SI_REF_SEED = 32, 11     # streamref_region's waves of 256
SI_HUB_PRODUCERS, SI_HUB_WAVES, SI_HUB_SEED = 4, 8, 13  # hub_region
SI_HUB_CONSUMERS = 2
SI_HUB_SETTLE_S = 0.5       # the hub's consumers register before producers
SI_REMOTE = {"akka": {"stdout-loglevel": "OFF", "log-dead-letters": 0,
                      "actor": {"provider": "remote"},
                      "remote": {"transport": "inproc",
                                 "canonical": {"hostname": "local",
                                               "port": 0}}}}


def stream_gateway(system, launches: dict, flat: dict) -> None:
    """stream_gateway: two gateway_region(0) full-width counter regions
    (K1), one behind gl.serve_stack(transport="stream") on `system` (a
    framed stage graph per accepted connection), one behind the evloop
    transport. gateway_serve's trace (16 clients x 512 adds over 64
    entities each, windows of 8, depth 4, real TCP loopback) runs as
    interleaved legs stream, evloop, evloop, stream: the first pair on
    client_traces seed 1 over fresh regions, the second on seed 2 (fresh
    entities on both). No error replies; every reply its client's running
    total; each seed's replies equal across the transports; sum_all ==
    the acked adds + the warm-up. K1 once a region step, held to its plain
    version on the fullest inbox of one more (untimed) stream-transport
    load."""
    label = "stream_gateway"
    stacks, counts, steps = {}, {}, {}
    try:
        for transport in ("stream", "evloop"):
            region = gateway_region(0)
            backend, srv = gl.serve_stack(
                region, transport=transport,
                system=system if transport == "stream" else None)
            stacks[transport] = (region, backend, srv)
            warm = backend.ask_many([f"warm-{i}" for i in range(GW_WARM)],
                                    [1.0] * GW_WARM)
            check(warm == [1.0] * GW_WARM, f"{label}: {transport} warm-up")
            counts[transport], steps[transport] = Launches(), 0
        check(stacks["stream"][2]._binding is not None,
              f"{label}: the stream transport bound its port once")
        results: Dict[int, dict] = {}
        acked = {"stream": 0.0, "evloop": 0.0}
        for transport, seed in SI_GW_LEGS:
            region, backend, srv = stacks[transport]
            traces = gl.client_traces(seed, GW_CLIENTS, GW_ENTS, GW_ADDS)
            s0 = region.system._host_step

            def leg():
                res = gl.drive(srv.host, srv.port, traces)
                check(backend.batcher.quiesce(ACTOR_TIMEOUT),
                      f"{label}: {transport} quiesce")
                return res
            res = counts[transport](leg)
            steps[transport] += region.system._host_step - s0
            check(not res.errors, f"{label}: {transport} seed {seed}: no "
                  f"error replies ({res.errors[:3]})")
            want = sum(len(w) for t in traces for w in t)
            check(res.requests == want, f"{label}: {transport}: "
                  f"{res.requests} acked of {want} adds")
            check(gl.running_totals_hold(res), f"{label}: {transport}: "
                  f"every reply equals its client's running total")
            acked[transport] += res.acked
            results.setdefault(seed, {})[transport] = res
            lat = np.asarray(res.latencies) * 1e3
            print(f"{label} leg {transport} seed {seed} requests "
                  f"{res.requests} requests_per_s "
                  f"{res.requests / res.seconds} reply_ms_p50 "
                  f"{np.percentile(lat, 50)} reply_ms_p99 "
                  f"{np.percentile(lat, 99)} sheds {res.sheds} (per window "
                  f"of 8, client side; host clock)")
        for seed, by in results.items():
            check(by["stream"].replies == by["evloop"].replies,
                  f"{label}: seed {seed}: the stream transport's replies "
                  f"equal the evloop transport's")
        for transport, (region, backend, srv) in stacks.items():
            total = backend.sum_all()
            check(total == acked[transport] + GW_WARM, f"{label}: "
                  f"{transport} sum_all {total} == acked "
                  f"{acked[transport]} + warm-up {GW_WARM}")
            check(region.ask_pool_stats()["in_flight"] == 0,
                  f"{label}: {transport}: no ask in flight")
        for transport in ("stream", "evloop"):
            rates = [r[transport].requests / r[transport].seconds
                     for r in results.values()]
            print(f"{label} {transport} requests_per_s_median "
                  f"{float(np.median(rates))} legs {rates}")
        # K1's input: the fullest inbox of one more load, untimed
        region, backend, srv = stacks["stream"]
        extra = gl.client_traces(3, GW_CLIENTS, 8, 64)
        s0 = region.system._host_step
        with StepProbe(region.system, True, *DD_PROBE) as probe:
            res = counts["stream"](lambda: (
                gl.drive(srv.host, srv.port, extra),
                backend.batcher.quiesce(ACTOR_TIMEOUT))[0])
        steps["stream"] += region.system._host_step - s0
        check(not res.errors and gl.running_totals_hold(res),
              f"{label}: the probed load's replies")
        graph_line(label, region.system)
        counts["stream"].report(label, "ring_reduce", launches,
                                steps["stream"])
        counts["evloop"].report(label + "_evloop", "ring_reduce", launches,
                                steps["evloop"])
        check(probe.rows > 0 and int(probe.inputs[0][3].sum()) > 0,
              f"{label}: K1's input carries messages ({probe.rows} rows)")
        print(f"{label} kernel_input live_rows {probe.rows} of "
              f"{probe.inputs[0][0].shape[0]}")
        flat[label] = ("K1", probe.inputs, SLOTS)
    finally:
        for region, backend, srv in stacks.values():
            srv.stop()
            backend.close()
    for transport, (region, backend, srv) in stacks.items():
        if transport == "stream":
            check(srv._binding is None, f"{label}: stop() unbound the "
                  f"stream transport")
    del stacks
    free()


class RefOffer(Actor):
    """streamref_region's node B: answers "offer" with (the SourceRef of
    its waves, the SinkRef its replies come back through). A stream ref's
    materialized value is a local lazy class that the wire codec refuses
    (in both packages): what crosses is `SourceRef(origin_path)` and
    `SinkRef(target_path)`, as the reference's own tests build them."""

    def __init__(self, source_ref, sink_ref):
        super().__init__()
        self.refs = (st.SourceRef(source_ref.origin_path),
                     st.SinkRef(sink_ref.target_path))

    def receive(self, message):
        if message == "offer":
            self.sender.tell(self.refs, self.self_ref)
        else:
            return NotImplemented


def streamref_region(launches: dict, flat: dict) -> None:
    """streamref_region: two provider = remote systems over the in-proc
    transport. Node B runs SI_REF_WAVES waves of 256 adds (make_trace,
    seed SI_REF_SEED) into StreamRefs.source_ref() and materializes
    StreamRefs.sink_ref() into Sink.seq; an actor of B hands both refs to
    node A over the wire. Node A, with gateway_region(0)'s full-width
    counter region (K1) behind RegionBackend(continuous=True), runs
    SourceRef.source(ref) -> map_async(SI_CONC, ask_many_async) ->
    SinkRef.sink(ref): every reply B receives equals the oracle's running
    total, in element order. K1 once a region step, held to its plain
    version on the fullest inbox (CUDA events and a sync around each
    flush, as stream_region)."""
    label = "streamref_region"
    a = ActorSystem.create("streamref-a", SI_REMOTE)
    b = ActorSystem.create("streamref-b", SI_REMOTE)
    backend = None
    try:
        trace = make_trace(SI_REF_SEED, SI_REF_WAVES)
        source_ref = st.Source.from_iterable(trace).run_with(
            st.StreamRefs.source_ref(), b)
        sink_ref, got = st.StreamRefs.sink_ref().to_mat(
            st.Sink.seq(), st.Keep.both).run(b)
        b.actor_of(Props.create(RefOffer, source_ref, sink_ref), "offer")
        offer = a.provider.resolve_actor_ref(
            f"{b.provider.local_address}/user/offer")
        check(isinstance(offer, RemoteActorRef), f"{label}: B's offer is "
              f"a remote ref on A")
        src, sink = ask_sync(offer, "offer", ACTOR_TIMEOUT, a)
        check(type(src) is st.SourceRef and type(sink) is st.SinkRef,
              f"{label}: the refs crossed the wire "
              f"({type(src).__name__}, {type(sink).__name__})")
        region = gateway_region(0)
        region.system.warmup()
        backend = RegionBackend(region, continuous=True, pipeline_depth=4)
        wave = wave_entry(backend)
        count = Launches()
        s0 = region.system._host_step

        def run():
            st.SourceRef.source(src).map_async(SI_CONC, wave) \
                .run_with(st.SinkRef.sink(sink), a)
            out = got.result(ACTOR_TIMEOUT * 2)
            check(backend.batcher.quiesce(ACTOR_TIMEOUT),
                  f"{label}: quiesce")
            return out
        with StepProbe(region.system, True, *DD_PROBE) as probe:
            t0 = time.perf_counter()
            replies = count(run)
            wall = time.perf_counter() - t0
        steps = region.system._host_step - s0
        oracle: dict = {}
        hold_waves(label, trace, replies, oracle)
        check(backend.sum_all() == sum(oracle.values()),
              f"{label}: sum_all == the oracle's sum")
        adds = sum(len(w) for w in trace)
        print(f"{label} waves {len(trace)} waves_per_s {len(trace) / wall} "
              f"adds_per_s {adds / wall} steps {steps} busy_ms "
              f"{probe.busy_ms} wall_ms {wall * 1e3} (host clock; CUDA "
              f"events around each flush)")
        count.report(label, "ring_reduce", launches, steps)
        check(probe.rows > 0 and int(probe.inputs[0][3].sum()) > 0,
              f"{label}: K1's input carries messages ({probe.rows} rows)")
        print(f"{label} kernel_input live_rows {probe.rows} of "
              f"{probe.inputs[0][0].shape[0]}")
        flat[label] = ("K1", probe.inputs, SLOTS)
    finally:
        if backend is not None:
            backend.close()
        for s in (a, b):
            s.terminate()
        for s in (a, b):
            check(s.await_termination(ACTOR_TIMEOUT),
                  f"{label}: {s.name} terminated")
    free()


def hub_region(system, launches: dict, flat: dict) -> None:
    """hub_region: gateway_region(SLOTS)'s full-width bounded-slots
    counter region (K2) behind RegionBackend(continuous=True). A MergeHub
    source -> KillSwitches.single() -> map_async(SI_CONC, ask_many_async)
    -> BroadcastHub sink; SI_HUB_CONSUMERS consumers attach to the
    broadcast side, then SI_HUB_PRODUCERS producers, each SI_HUB_WAVES
    waves of 256 adds on ids of their own, attach to the merge side. Each
    consumer sees every reply wave, each producer's in its order, every
    reply the oracle's running total; the switch then ends the hub.
    K2 once a region step, held to its plain version on the fullest
    inbox."""
    label = "hub_region"
    region = gateway_region(SLOTS)
    region.system.warmup()
    backend = RegionBackend(region, continuous=True, pipeline_depth=4)
    try:
        def tagged(e):
            p, k, asks = e
            fut: Future = Future()
            backend.ask_many_async(
                [n for n, _ in asks], [v for _, v in asks], None,
                lambda out, _s: fut.set_result((p, k, out)))
            return fut
        traces = {p: [[(f"hub{p}-{n}", v) for n, v in w]
                      for w in make_trace(SI_HUB_SEED + p, SI_HUB_WAVES)]
                  for p in range(SI_HUB_PRODUCERS)}
        n_waves = SI_HUB_PRODUCERS * SI_HUB_WAVES
        count = Launches()
        s0 = region.system._host_step

        def run():
            (attach_sink, switch), attach_source = \
                st.MergeHub.source(16) \
                .via_mat(st.KillSwitches.single(), st.Keep.both) \
                .map_async(SI_CONC, tagged) \
                .to_mat(st.BroadcastHub.sink(64), st.Keep.both) \
                .run(system)
            seen = [attach_source.take(n_waves).run_with(st.Sink.seq(),
                                                         system)
                    for _ in range(SI_HUB_CONSUMERS)]
            time.sleep(SI_HUB_SETTLE_S)
            t0 = time.perf_counter()
            for p, waves in traces.items():
                st.Source.from_iterable(
                    [(p, k, w) for k, w in enumerate(waves)]) \
                    .to(attach_sink, st.Keep.right).run(system)
            out = [f.result(ACTOR_TIMEOUT * 2) for f in seen]
            wall = time.perf_counter() - t0
            switch.shutdown()
            check(backend.batcher.quiesce(ACTOR_TIMEOUT),
                  f"{label}: quiesce")
            return out, wall
        with StepProbe(region.system, True, *DD_PROBE) as probe:
            (seen, wall) = count(run)
        steps = region.system._host_step - s0
        check(seen[0] == seen[1], f"{label}: both consumers saw the same "
              f"reply stream")
        for c, waves in enumerate(seen):
            check(len(waves) == n_waves, f"{label}: consumer {c} saw "
                  f"{len(waves)} of {n_waves} waves")
            oracle: dict = {}
            for p, trace in traces.items():
                mine = [(k, out) for q, k, out in waves if q == p]
                check([k for k, _ in mine] == list(range(SI_HUB_WAVES)),
                      f"{label}: consumer {c}: producer {p}'s waves in "
                      f"its order")
                hold_waves(f"{label} consumer {c}", trace,
                           [out for _, out in mine], oracle)
        check(backend.sum_all() == sum(oracle.values()),
              f"{label}: sum_all == the oracle's sum")
        adds = n_waves * WAVE_ASKS
        print(f"{label} waves {n_waves} waves_per_s {n_waves / wall} "
              f"adds_per_s {adds / wall} steps {steps} busy_ms "
              f"{probe.busy_ms} wall_ms {wall * 1e3} (host clock from the "
              f"producers' start; CUDA events around each flush)")
        count.report(label, "ring_slots", launches, steps)
        check(probe.rows > 0 and int(probe.inputs[0][3].sum()) > 0,
              f"{label}: K2's input carries messages ({probe.rows} rows)")
        print(f"{label} kernel_input live_rows {probe.rows} of "
              f"{probe.inputs[0][0].shape[0]}")
        flat[label] = ("K2", probe.inputs, SLOTS)
    finally:
        backend.close()
    del region, backend
    free()


def stream_io_paths(launches: dict) -> dict:
    """stream_io_paths: stream_gateway and hub_region on one ActorSystem,
    streamref_region on two of its own; every system terminated and
    awaited. Returns the K1 and K2 delivery inputs by label."""
    cfg = {"akka": {"stdout-loglevel": "OFF", "log-dead-letters": 0}}
    flat: dict = {}
    print(f"stream_io_paths threads_at_start {threading.active_count()}")
    t_phase = time.perf_counter()
    system = ActorSystem.create("stream-io-paths", cfg)
    try:
        t0 = time.perf_counter()
        stream_gateway(system, launches, flat)
        print(f"stream_gateway phase_s {time.perf_counter() - t0}")
        t0 = time.perf_counter()
        streamref_region(launches, flat)
        print(f"streamref_region phase_s {time.perf_counter() - t0}")
        t0 = time.perf_counter()
        hub_region(system, launches, flat)
        print(f"hub_region phase_s {time.perf_counter() - t0}")
    finally:
        system.terminate()
        check(system.await_termination(ACTOR_TIMEOUT),
              "stream_io_paths: the system terminated")
    del system
    free()
    print(f"stream_io_paths phase_s {time.perf_counter() - t_phase}")
    return flat


def stream_io_phase_only(runs: int, smi: str) -> int:
    """`python3 chip_smoke.py --stream-io-phase N`: stream_io_paths alone,
    N times in one process, every check as in the whole run and K1 and K2
    held to their plain versions on each run's fullest inboxes. The last
    line is {"stream_io_phase_s": [...]}."""
    lib = cm.build()
    times = []
    for r in range(runs):
        launches: Dict[str, dict] = {}
        t0 = time.perf_counter()
        flat = stream_io_paths(launches)
        times.append(time.perf_counter() - t0)
        check(times[-1] < SI_PHASE_S, f"stream_io_paths run {r}: "
              f"{times[-1]} s, more than {SI_PHASE_S}")
        for label, (k, (inputs, n), slots) in flat.items():
            row = kernel_rows(label, inputs, n, lib, kernels=(k,),
                              slots=slots)[k]
            print(f"stream_io_phase_run {r} {label} {k} {json.dumps(row)}")
        print(f"stream_io_phase_run {r} stream_io_phase_s {times[-1]} "
              f"launches {json.dumps(launches)}")
    print(smi)
    print(json.dumps({"stream_io_phase_s": times}))
    return 0



def path_dtype(label: str) -> str:
    """The payload dtype of a path's system, by the path's name."""
    for name in ("int32", "bf16"):
        if label.endswith(f"_{name}"):
            return name
    return "float32"


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    smi = bm.card_line()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    lib = cm.build(verbose=True)
    print(f"build_s {time.perf_counter() - t0}")
    if sys.argv[1:2] == ["--remote-phase"]:
        return remote_phase_only(int(sys.argv[2]), smi)
    if sys.argv[1:2] == ["--ddata-phase"]:
        return ddata_phase_only(int(sys.argv[2]), smi)
    if sys.argv[1:2] == ["--sharding-phase"]:
        return sharding_phase_only(int(sys.argv[2]), smi)
    if sys.argv[1:2] == ["--stream-phase"]:
        return stream_phase_only(int(sys.argv[2]), smi)
    if sys.argv[1:2] == ["--stream-io-phase"]:
        return stream_io_phase_only(int(sys.argv[2]), smi)

    t0 = time.perf_counter()
    rows, typed = kernel_phase(lib)
    print(f"kernel_phase_s {time.perf_counter() - t0}")
    launches: Dict[str, dict] = {}
    single_device_paths(launches)
    t0 = time.perf_counter()
    supervision_paths(launches)
    print(f"supervision_phase_s {time.perf_counter() - t0}")
    sharded = sharded_paths(launches)
    region = region_paths(launches)
    gateway = gateway_paths(launches)
    durability_paths(launches)
    observed_paths(launches)
    actor = actor_paths(launches)
    t0 = time.perf_counter()
    router = baseline_paths(launches)
    print(f"baseline_phase_s {time.perf_counter() - t0}")
    for label, phase in (("pipeline", pipeline_paths),
                         ("staging", staging_paths)):
        t0 = time.perf_counter()
        phase(launches)
        print(f"{label}_phase_s {time.perf_counter() - t0}")
    t0 = time.perf_counter()
    failover = failover_paths(launches)
    print(f"failover_phase_s {time.perf_counter() - t0}")
    t0 = time.perf_counter()
    ranks = rank_paths(launches)
    print(f"rank_phase_s {time.perf_counter() - t0}")
    t0 = time.perf_counter()
    ledgers = typed_persistence_paths(launches)
    phase_s = time.perf_counter() - t0
    print(f"typed_persistence_phase_s {phase_s}")
    check(phase_s < TP_PHASE_S, f"typed_persistence: {phase_s} s, more "
          f"than {TP_PHASE_S}")
    t0 = time.perf_counter()
    remote = remote_paths(launches)
    phase_s = time.perf_counter() - t0
    print(f"remote_phase_s {phase_s}")
    check(phase_s < REMOTE_PHASE_S, f"remote_paths: {phase_s} s, more "
          f"than {REMOTE_PHASE_S}")
    t0 = time.perf_counter()
    ddata = ddata_paths(launches)
    phase_s = time.perf_counter() - t0
    print(f"ddata_phase_s {phase_s}")
    check(phase_s < DD_PHASE_S, f"ddata_paths: {phase_s} s, more than "
          f"{DD_PHASE_S}")
    t0 = time.perf_counter()
    sharding = sharding_paths(launches)
    phase_s = time.perf_counter() - t0
    print(f"sharding_phase_s {phase_s}")
    check(phase_s < SH_PHASE_S, f"sharding_paths: {phase_s} s, more "
          f"than {SH_PHASE_S}")
    t0 = time.perf_counter()
    stream = stream_paths(launches)
    phase_s = time.perf_counter() - t0
    print(f"stream_phase_s {phase_s}")
    check(phase_s < ST_PHASE_S, f"stream_paths: {phase_s} s, more than "
          f"{ST_PHASE_S}")
    t0 = time.perf_counter()
    stream_io = stream_io_paths(launches)
    phase_s = time.perf_counter() - t0
    print(f"stream_io_phase_s {phase_s}")
    check(phase_s < SI_PHASE_S, f"stream_io_paths: {phase_s} s, more "
          f"than {SI_PHASE_S}")
    # both kernels at the shapes the new paths gave them
    t0 = time.perf_counter()
    for label, flat in (("sharded_d8", sharded), ("region", region),
                        ("gateway", gateway), ("router", router),
                        *failover.items(), *ranks.items()):
        for k, (inputs, n) in flat.items():
            rows.setdefault(label, {})[k] = kernel_rows(
                label, inputs, n, lib, kernels=(k,))[k]
    for label, (k, (inputs, n), slots) in {**actor, **ledgers, **remote,
                                           **ddata, **sharding, **stream,
                                           **stream_io}.items():
        dtype = path_dtype(label)
        table = rows if dtype == "float32" else typed[dtype]
        table.setdefault(label, {})[k] = kernel_rows(
            label, inputs, n, lib, kernels=(k,), slots=slots)[k]
    del sharded, region, gateway, actor, router, failover, ranks, ledgers
    del remote, ddata, sharding, stream, stream_io
    print(f"path_kernels_s {time.perf_counter() - t0}")

    entry = {"K1": ("ring_reduce", "_run(with_slots=False)"),
             "K2": ("ring_slots", "_run(with_slots=True)")}
    kernels = []
    for k, (cname, mode) in entry.items():
        # one row per payload dtype; a path's launches count under its
        # system's dtype (the cells named *_int32, *_bf16; the rest float32)
        for dname, table in (("float32", rows), *typed.items()):
            by_pattern = {pat: r[k] for pat, r in table.items() if k in r}
            by_path = {p: c[cname] for p, c in launches.items()
                       if path_dtype(p) == dname}
            kernels.append({
                "name": f"{k} {cname} {dname}", "route": "cuda",
                "source": "akka_tpu_torch/csrc/ring_mailbox.cu",
                "replaces": f"akka_tpu/ops/pallas_mailbox.py:137 {mode}",
                "dtype": dname,
                "launches": sum(by_path.values()),
                "bound_by": "bytes",
                **table["random"][k],
                "max_abs_err": max(r["max_abs_err"]
                                   for r in by_pattern.values()),
                "launches_by_path": by_path,
                "patterns": by_pattern})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
