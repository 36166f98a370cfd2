"""Patterns of the port: ask (`ask`), the circuit breaker
(`circuit_breaker`), and the backoff supervisor with retry and graceful
stop (`backoff`: `BackoffSupervisor`, `retry`, `graceful_stop`,
`backoff_delay`)."""
