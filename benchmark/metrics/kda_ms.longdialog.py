"""kda_ms.longdialog: device milliseconds a traced batch of the operations
launched under the program's span `lm.kda` (a KDA layer's eager call in
the prefill: projections, convolutions, gates, the chunked scan under
`lm.kda.scan`, the gated norm and the output; no span is open inside a
graph replay, so the decode's steps are not in it). None where the program
opens no such span."""


def read(run):
    if run.trace is None or not run.traced:
        return None
    spent = run.trace.device_s("lm.kda")
    if spent <= 0:
        return None
    return 1e3 * spent / len(run.traced)
