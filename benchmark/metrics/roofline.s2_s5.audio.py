"""roofline.s2_s5.audio: the least time the vocoder's stages s2..s5 could
take on the traced requests' clips (counts/vocoder.py, each clip at its own
length, the peak rule of counts/__init__.py), over the device time of the
kernels launched under the spans vocoder.s2 .. vocoder.s5."""

from benchmark.counts import stage_share


def read(run):
    return stage_share(run, (2, 3, 4, 5))
