"""Development probes of the port's own kernels (not on any serving path)."""
