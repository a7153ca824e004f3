"""The harness: what BENCHMARK.json names, the run, the trace, seeded weights."""
