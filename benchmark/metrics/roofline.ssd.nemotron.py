"""roofline.ssd.nemotron: the least time of the chunked SSD's work in the
traced batches' prefills (counts/ssd.py `scan_work` of the records'
`ssd_positions`, one final state a row and Mamba layer; the peak rule of
counts/__init__.py at the cell's dtype) over the device time of the
operations launched under the program's span `lm.mamba.scan` (the chunked
core only). The same work whatever implements the scan; None without the
counter or the span."""

from benchmark.counts import least_s
from benchmark.counts.ssd import scan_work


def read(run):
    if run.trace is None or not run.traced or not all(r.get("ssd_positions") for r in run.traced):
        return None
    spent = run.trace.device_s("lm.mamba.scan")
    if spent <= 0:
        return None
    layers = run.config["hybrid_override_pattern"].count("M")
    flops = nbytes = 0.0
    for r in run.traced:
        f, b = scan_work(run.config, r["ssd_positions"], len(r["frames"]) * layers, run.itemsize)
        flops, nbytes = flops + f, nbytes + b
    return 100.0 * least_s(flops, nbytes, run.itemsize) / spent
