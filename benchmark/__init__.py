"""The benchmark of dmel_codec_tpu_torch on NVIDIA GPUs: a data-driven
harness (`python3 -m benchmark.run`) that finds each cell's traffic,
configuration, driver and metric readers by name. See README.md."""
