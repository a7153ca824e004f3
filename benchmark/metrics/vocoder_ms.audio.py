"""vocoder_ms.audio: device milliseconds of the kernels launched under the
vocoder's spans, per second of audio, in the traced slice."""


def read(run):
    if run.trace is None or not run.traced:
        return None
    ms = run.trace.device_s("vocoder.") * 1e3
    return ms / sum(r["audio_s"] for r in run.traced) if ms > 0 else None
