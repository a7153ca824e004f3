"""codec_idle_ms.single: device-idle milliseconds a traced request while
the innermost span open on the host is one of the codec's (`codec.mel`,
`codec.encode*`, `codec.decode*`: the program's own spans inside the
driver's), from the trace's idle gaps; None without such spans."""


def read(run):
    trace = run.trace
    if trace is None or not run.traced or not any(name.startswith("codec.") for name, _, _ in trace.spans):
        return None
    gaps = trace.idle_gaps(len(trace.spans) + 1)  # every name that holds a gap
    return 1e3 * sum(s for name, s in gaps if name.startswith("codec.")) / len(run.traced)
