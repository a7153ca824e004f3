"""codec_launches.single: kernels a traced request launched under the
codec's spans (`codec.*`: front end, encoder, FSQ, decoder); the rest of
`launches.single` is the vocoder's and the request's own. None without
such spans."""


def read(run):
    trace = run.trace
    if trace is None or not run.traced or not any(name.startswith("codec.") for name, _, _ in trace.spans):
        return None
    return sum(o.kernel for o in trace.under("codec.")) / len(run.traced)
