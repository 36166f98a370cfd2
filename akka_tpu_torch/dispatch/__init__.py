"""Dispatchers and mailboxes of the host actor core (port of
`akka_tpu/dispatch`): the thread-pool dispatchers, the mailbox status
machine, system messages, and the `tpu-batched` dispatcher type that owns
a device runtime handle (`batched.py`)."""
