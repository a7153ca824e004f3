"""frame_ms.serve: host-clock milliseconds of `generate_batched` (prefill,
graph replays and the fetch) over the frame steps it made, over the batches
that ran outside the traced slice (the profiler's own cost stays out), or
over all of them where every batch was traced."""


def read(run):
    if run.trace is None:
        return None
    records = [r for r in run.records if not r.get("traced")] or run.records
    return 1e3 * sum(r["gen_s"] for r in records) / sum(r["gen_steps"] for r in records)
