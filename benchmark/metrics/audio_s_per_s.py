"""audio_s_per_s: seconds of real audio (not padding) delivered to the host
by the window's requests, over the window's wall seconds (from its start to
the last completion)."""


def read(run):
    return sum(r["audio_s"] for r in run.records) / run.window_s
