"""FSQ and the downsample-FSQ token bottleneck."""
