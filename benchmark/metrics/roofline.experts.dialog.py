"""roofline.experts.dialog: the least time of the routed experts' work in
the traced batches' prefills (counts/moe.py on the program's pair counter,
`pairs_prefill`; the peak rule of counts/__init__.py), over the device time
of the operations launched under the program's span `lm.moe.experts` (the
prefill's: no span is open inside a graph replay). The same work whatever
implements it; None without the counter or the span."""

from benchmark.counts import least_s
from benchmark.counts.moe import experts_work


def read(run):
    if run.trace is None or not run.traced or not all("pairs_prefill" in r for r in run.traced):
        return None
    spent = run.trace.device_s("lm.moe.experts")
    if spent <= 0:
        return None
    flops = nbytes = 0.0
    for r in run.traced:
        f, b = experts_work(run.config, r["pairs_prefill"], run.itemsize)
        flops, nbytes = flops + f, nbytes + b
    return 100.0 * least_s(flops, nbytes, run.itemsize) / spent
