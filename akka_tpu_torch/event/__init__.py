"""The port's telemetry plane: the flight recorder and the profiler
brackets (`flight_recorder`), the metrics registry (`metrics`), causal
tracing (`tracing`) and runtime pressure signals (`pressure`)."""
