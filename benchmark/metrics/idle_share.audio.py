"""idle_share.audio: the share of the traced slice in which no
operation ran on the device (the union of kernel, memcpy and memset
intervals); Run.idle_percent."""


def read(run):
    return run.idle_percent
