"""prefill_idle_ms.serve: device-idle milliseconds a traced batch while the
innermost span open on the host is the program's `lm.prefill` (the
prompts' upload and the eager prefill of `SlowFastGenerator`), from the
trace's idle gaps; None without that span."""


def read(run):
    trace = run.trace
    if trace is None or not run.traced or not any(name.startswith("lm.prefill") for name, _, _ in trace.spans):
        return None
    gaps = trace.idle_gaps(len(trace.spans) + 1)  # every name that holds a gap
    return 1e3 * sum(s for name, s in gaps if name.startswith("lm.prefill")) / len(run.traced)
