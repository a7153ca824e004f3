"""mfu.nemotron: the model operations of the work completed in the traced
slice (the LM's as far as the trace holds the generation, counted by
counts/ssd.py with only the routed pairs of the experts this chip holds;
the render's codec decode and vocoder), over the slice's seconds times the
peak of the cell's dtype."""

from benchmark.counts import model_flops, peak_flops


def read(run):
    if run.trace is None or not run.traced:
        return None
    flops = sum(model_flops(run.audio_config, r, traced=True) for r in run.traced)
    return 100.0 * flops / (run.trace.window_s * peak_flops(run.itemsize))
