"""The yardstick's arithmetic: the card's peaks and the operations and bytes
of each piece of work, from its shapes.

Copied out of the program's own measuring code (`chip_smoke.py`:
`stage_shapes`, `stage_bound_ms`, `fa_bound_ms`, phase 19's `bwd_bound_ms`,
`K1_FLOPS_PER_SAMPLE`; `dmel_codec_tpu_torch/probes/timing.py`'s peaks), so
that later changes to the program do not move the yardstick.

The peak rule, the same for every roofline and every `mfu`: bf16 work
counts against 989 TFLOP/s; float32 work counts its model operations (not
split-TF32's three products) against the TF32 rate, 494.7 TFLOP/s, since a
float32-accurate product cannot beat one TF32 pass. So no legitimate change
can read above 100 %. Bytes count against 3.35 TB/s, each input read once
and each output written once.
"""

# Published dense peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet).
PEAK_BF16 = 989e12
PEAK_TF32 = 494.7e12
PEAK_BYTES = 3.35e12


def peak_flops(itemsize: int) -> float:
    """The rate a piece of work's operations count against: bf16 (2 bytes)
    at the bf16 tensor-core rate, float32 (4) at the TF32 rate."""
    if itemsize not in (2, 4):
        raise ValueError(f"no peak for {itemsize}-byte elements")
    return PEAK_BF16 if itemsize == 2 else PEAK_TF32


def least_s(flops: float, nbytes: float, itemsize: int) -> float:
    """The least time the card could take: the larger of operations over
    the peak of their type and bytes over the memory's rate."""
    return max(flops / peak_flops(itemsize), nbytes / PEAK_BYTES)


def model_flops(config: dict, record: dict, traced: bool = False) -> float:
    """The model operations of one unit of work's record: the codec
    (`config` holds its "codec" and "vocoder") on its clips' `frames` (the
    encode unless the record says `encoded` False, the decode and the
    vocoder), and `lm_flops` where the unit ran the LM (with `traced`, the
    part of it inside the trace, `lm_flops_traced`, where the record has it)."""
    from benchmark.counts import codec, vocoder

    flops = float(record.get("lm_flops_traced" if traced and "lm_flops_traced" in record else "lm_flops", 0.0))
    frames = record.get("frames")
    if frames:
        flops += codec.encode_flops(config["codec"], frames) if record.get("encoded", True) else 0.0
        flops += codec.decode_flops(config["codec"], frames) + vocoder.vocoder_flops(config["vocoder"], frames)
    return flops


def stage_share(run, stages) -> "float | None":
    """Percent of the least time of the vocoder's `stages` on the traced
    records' clips over the device time under their `vocoder.s<i>` spans."""
    from benchmark.counts import vocoder

    if run.trace is None or not run.traced:
        return None
    spent = run.trace.device_s(*(f"vocoder.s{i}" for i in stages))
    if spent <= 0:
        return None
    frames = [f for r in run.traced for f in r["frames"]]
    work = [vocoder.stage_work(run.audio_config["vocoder"], i, frames, run.itemsize) for i in stages]
    flops = sum(f for f, _ in work)
    nbytes = sum(b for _, b in work)
    return 100.0 * least_s(flops, nbytes, run.itemsize) / spent
