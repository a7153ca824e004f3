"""setup_s: seconds from the process's start to the first timed unit of work
(imports, weights made from the seed, the kernels' build or load, every
shape of the cell warmed up, graph captures)."""


def read(run):
    return run.setup_s
