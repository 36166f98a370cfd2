"""Remoting: the failure detectors (`failure_detector.py`), the wire
(`transport.py`: in-proc, TCP with its lanes, TLS over pki/), the remote
provider and its deathwatch (`provider.py`), remote deployment
(`deploy.py`) and the wire instruments (`instrument.py`), each a copy of
its `akka_tpu/remote/` module. The reference's `remote/__init__.py` is
empty and exports nothing."""
