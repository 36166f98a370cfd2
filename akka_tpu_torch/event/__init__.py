"""The port's event plane: the event stream and logging
(`event_stream`, `logging`), the flight recorder and the profiler
brackets (`flight_recorder`), the metrics registry (`metrics`), causal
tracing (`tracing`) and runtime pressure signals (`pressure`)."""
