"""mfu.audio: the model operations of the work completed in the traced slice
(the codec's encode and decode and the vocoder on every clip at its own
length, and the LM's where the cell generates, as far as the trace holds
it; counts/), over the slice's seconds times the peak of the cell's dtype."""

from benchmark.counts import model_flops, peak_flops


def read(run):
    if run.trace is None or not run.traced:
        return None
    flops = sum(model_flops(run.audio_config, r, traced=True) for r in run.traced)
    return 100.0 * flops / (run.trace.window_s * peak_flops(run.itemsize))
