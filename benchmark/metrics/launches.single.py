"""launches.single: device kernel launches per request in the traced slice
(a graph replay counts its kernels), from the trace."""


def read(run):
    if run.trace is None or not run.traced:
        return None
    return run.trace.kernels() / len(run.traced)
