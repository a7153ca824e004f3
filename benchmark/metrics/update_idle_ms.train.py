"""update_idle_ms.train: device-idle milliseconds a traced micro-step while
the innermost span open on the host is the optimizer's (`train.update`,
`train.update.guard`: the non-finite guard's host read, `train.update.clip`:
the global norm's), from the trace's idle gaps; None without those spans."""


def read(run):
    trace = run.trace
    if trace is None or not run.traced or not any(name.startswith("train.update") for name, _, _ in trace.spans):
        return None
    gaps = trace.idle_gaps(len(trace.spans) + 1)  # every name that holds a gap
    return 1e3 * sum(s for name, s in gaps if name.startswith("train.update")) / len(run.traced)
