"""The CUDA runtime's kernel-launch and graph-launch calls on the host an
update: what the outer iteration and the captured programs cost the host."""


def read(trace):
    calls = sum(1 for name, _, _ in trace.host
                if "LaunchKernel" in name or "GraphLaunch" in name)
    return calls / trace.updates
