"""mla_attend_ms.dialog: device milliseconds a traced batch of the
operations launched under the program's span `lm.mla.attend`: the attention
core of latent attention's expanded form in the prefill (kernel K5, or the
plain chunked core), without the projections around it; no span is open
inside a graph replay, so the decode's absorbed form is not in it. None
where the program opens no such span."""


def read(run):
    if run.trace is None or not run.traced:
        return None
    spent = run.trace.device_s("lm.mla.attend")
    if spent <= 0:
        return None
    return 1e3 * spent / len(run.traced)
