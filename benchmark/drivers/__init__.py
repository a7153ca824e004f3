"""One driver per kind of traffic; a workload file names its driver."""
