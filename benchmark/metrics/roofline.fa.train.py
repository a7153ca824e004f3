"""roofline.fa.train: the least time of the slow decoder's causal GQA
attention, forward and backward, in the traced micro-steps (counts/lm.py,
the peak rule of counts/__init__.py), over the device time of the
attention kernels. The profiler correlates those kernels to no benchmark
span (attention is deep inside the train step), so they are found by name:
the kernel families of FA (flash_attention_*), FA-dQ (dq_*) and FA-dKV
(dkv_*)."""

from benchmark.counts import least_s
from benchmark.counts.lm import attention_train_work

KERNELS = ("flash_attention", "dq_", "dkv_")


def read(run):
    if run.trace is None or not run.traced:
        return None
    ops = [o for o in run.trace.ops if o.kernel and o.function.startswith(KERNELS)]
    spent = run.trace.busy_s(ops)
    if spent <= 0:
        return None
    size = run.itemsize
    flops, nbytes = attention_train_work(run.config, run.params["batch"], run.params["seq"], size)
    n = len(run.traced)
    return 100.0 * least_s(n * flops, n * nbytes, size) / spent
