"""Failure detectors (port of `akka_tpu/remote/failure_detector.py`, the
phi-accrual and deadline detectors the device sentinel uses). The remote
provider and transport are not ported (ROADMAP A12)."""
