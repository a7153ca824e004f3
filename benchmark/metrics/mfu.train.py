"""mfu.train: the model operations of the micro-steps completed in the
traced slice (counts/lm.py: three times the forward's products), over the
slice's seconds times the peak of the configuration's dtype."""

from benchmark.counts import peak_flops
from benchmark.counts.lm import train_flops


def read(run):
    if run.trace is None or not run.traced:
        return None
    b, s = run.params["batch"], run.params["seq"]
    flops = len(run.traced) * train_flops(run.config, b, s)
    return 100.0 * flops / (run.trace.window_s * peak_flops(run.itemsize))
