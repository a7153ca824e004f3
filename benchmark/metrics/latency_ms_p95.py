"""latency_ms_p95: the 95th percentile over every request of the window of
its time from the encode call to its waveform on the host."""

import numpy as np


def read(run):
    return float(np.percentile([r["latency_s"] for r in run.records], 95)) * 1e3
