"""idle_share.dialog: the share of the traced slice (the prefill, the
first graph replays, the render) in which no operation ran on the device
(the union of kernel, memcpy and memset intervals); Run.idle_percent."""


def read(run):
    return run.idle_percent
