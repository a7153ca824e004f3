"""roofline.s0_s1.audio: the least time the vocoder's stages s0 and s1
could take on the traced requests' clips (counts/vocoder.py, each clip at
its own length, the peak rule of counts/__init__.py), over the device time
of the kernels launched under the spans vocoder.s0 and vocoder.s1."""

from benchmark.counts import stage_share


def read(run):
    return stage_share(run, (0, 1))
