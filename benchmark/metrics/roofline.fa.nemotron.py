"""roofline.fa.nemotron: the least time of the attention layers' causal
GQA forward in the traced batches' prefills (counts/ssd.py `fa_work` over
each record's rows and `prompt` positions; the peak rule of
counts/__init__.py at the cell's dtype) over the device time of the
operations launched under the program's span `lm.attn.attend` (the
attention core only: FA on the card, or the plain core; no span is open
inside a graph replay, so the decode's steps are not in it). None without
the span or the record's prompt length."""

from benchmark.counts import least_s
from benchmark.counts.ssd import fa_work


def read(run):
    if run.trace is None or not run.traced or not all(r.get("prompt") for r in run.traced):
        return None
    spent = run.trace.device_s("lm.attn.attend")
    if spent <= 0:
        return None
    flops = nbytes = 0.0
    for r in run.traced:
        f, b = fa_work(run.config, len(r["frames"]), r["prompt"], run.itemsize)
        flops, nbytes = flops + f, nbytes + b
    return 100.0 * least_s(flops, nbytes, run.itemsize) / spent
