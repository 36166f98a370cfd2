"""The host actor core (port of `akka_tpu/actor`): ActorSystem, actor
cells and refs, Props, supervision, the scheduler and the FSM DSL. Device
actors spawn through the same `actor_of` (`batched/bridge.py`)."""
