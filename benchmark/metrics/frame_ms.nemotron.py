"""frame_ms.nemotron: host-clock milliseconds of a frame step after the
prefill over the long history with the Nemotron-H slow decoder:
`generate_batched`'s seconds from the prefill's last launch to the end of
its frame loop (`SlowFastGenerator.stats["replay_s"]`) over the frames
after the prefill, over the batches that ran outside the traced slice, or
over all of them where every batch was traced; None where the program does
not time its loop."""


def read(run):
    if run.trace is None:
        return None
    records = [r for r in run.records if not r.get("traced")] or run.records
    if not all("replay_s" in r for r in records):
        return None
    return 1e3 * sum(r["replay_s"] for r in records) / sum(max(1, r["gen_steps"] - 1) for r in records)
