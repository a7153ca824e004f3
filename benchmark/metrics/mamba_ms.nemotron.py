"""mamba_ms.nemotron: device milliseconds a traced batch of the
operations launched under the program's span `lm.mamba` (a Mamba-2 layer's
eager call in the prefill: in_proj, the convolution, dt, the chunked SSD
under `lm.mamba.scan`, the D skip, the gated norm and out_proj; no span is
open inside a graph replay, so the decode's steps are not in it). None
where the program opens no such span."""


def read(run):
    if run.trace is None or not run.traced:
        return None
    spent = run.trace.device_s("lm.mamba")
    if spent <= 0:
        return None
    return 1e3 * spent / len(run.traced)
