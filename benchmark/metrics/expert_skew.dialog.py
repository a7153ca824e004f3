"""expert_skew.dialog: the routed (token, expert) pairs of the busiest
expert over the mean of its layer, in the layer where that is largest, in
the traced batches' prefills (the program's pair counter, `pairs_prefill`;
1 is an even spread). None without the counter."""

import numpy as np


def read(run):
    if run.trace is None or not run.traced or not all("pairs_prefill" in r for r in run.traced):
        return None
    pairs = sum(np.asarray(r["pairs_prefill"], np.float64) for r in run.traced)  # [moe layers, experts]
    return float((pairs.max(axis=1) / pairs.mean(axis=1)).max())
