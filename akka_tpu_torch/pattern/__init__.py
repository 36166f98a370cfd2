"""Patterns of the port: ask (`ask`), the circuit breaker
(`circuit_breaker`) and retry backoff (`backoff.backoff_delay`)."""
