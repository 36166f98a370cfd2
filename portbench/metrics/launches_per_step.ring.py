"""launches_per_step.ring: the host's CUDA launch calls (kernels, graphs,
copies and memsets, on every thread) in the traced slice, over the steps
the slice ran (the arithmetic of the port's step profiler,
`host_launch_calls` in akka_tpu_torch/tools/profile_step.py)."""

from portbench.yardstick.trace import count_host

# the host's CUDA calls that put work on the card
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch",
                "cudaMemcpyAsync", "cudaMemsetAsync", "cudaMemcpy")


def read(ctx):
    steps = ctx.counters.get("trace_steps")
    if ctx.trace is None or not steps:
        return None
    return count_host(ctx.trace, LAUNCH_CALLS) / steps
