"""Telemetry helpers of the port: causal-tracing context (`tracing`) and
runtime pressure signals (`pressure`)."""
