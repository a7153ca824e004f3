"""Frames per second of the LM's served generation at full width, and a
same-card comparison of two checkouts.

    python3 -m dmel_codec_tpu_torch.probes.generate_times              # this checkout
    python3 -m dmel_codec_tpu_torch.probes.generate_times --ab OTHER   # OTHER, this, this, OTHER
    python3 -m dmel_codec_tpu_torch.probes.generate_times --per-replay 1,2,4,8   # this checkout, each
                                                                  # FRAMES_PER_GRAPH in turn, B = 1 and 16

The model is `ChatMusicLM(SlowFastLMConfig())` (slow 24 x 896, fast
12 x 480, vocabulary 151936) with seeded random bf16 weights, served as
`cli.infer_lm` serves it: the text prompt "who are you?" through
`TokenGridBuilder.build_infer_grid`, `InferenceConfig(max_new_tokens=128,
cache_dtype="bfloat16")` and the default sampler, seeded. At B = 1 through
`generate`, at B = 16 and 64 through `generate_batched` on the prompt
repeated. Per batch size: the prefill with the first frame (a generator
with max_new_tokens = 1), then whole generations: in a checkout that
captures a CUDA graph two, the first with the capture and the second the
steady state (its `stats` give the capture's seconds and the host's
reads); in one that does not (the parent of the captured loop), one. frames/s = (frames - 1) / (generation - prefill), per row (CUDA
events; the host waits for the result in both). Each run also
records a hash of the tokens the seed gives at each batch size: a checkout's
two runs must agree.

With `--ab` each run is its own process (this file run as a script from
the checkout's root) that imports the port from its checkout; it uses only
the public API, so the parent of the graphed loop runs it too. No
hand-written kernel runs here (the prompt is shorter than the flash
kernel's minimum length), so nothing is built. Prints one line per case
and run, and as its last line a JSON object {checkout: {case: mean of its
runs}}.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
BATCHES, FRAMES, SEED, PROMPT = (1, 16, 64), 128, 3, "who are you?"


def time_here(root: Path, batches=BATCHES, frames: int = FRAMES) -> dict:
    """{case: value} for the checkout at `root`: per batch size the prefill
    ms, both generations' ms, frames, frames/s per row, and the tokens' hash."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("generate_times: the probe times the LM on a GPU")
    sys.path.insert(0, str(root))
    from dmel_codec_tpu_torch.lm.generate import InferenceConfig, SlowFastGenerator
    from dmel_codec_tpu_torch.lm.inputs import TokenGridBuilder
    from dmel_codec_tpu_torch.lm.tokenizer import ByteTokenizer
    from dmel_codec_tpu_torch.models.lm import ChatMusicLM, SlowFastLMConfig

    dev = torch.device("cuda:0")
    torch.manual_seed(0)
    cfg = SlowFastLMConfig()
    with torch.device(dev):
        lm = ChatMusicLM(cfg)
    lm = lm.to(torch.bfloat16).eval()
    text, audio = TokenGridBuilder(config=cfg).build_infer_grid(text_ids=ByteTokenizer().encode(PROMPT))
    icfg = InferenceConfig(max_new_tokens=frames, cache_dtype="bfloat16")
    out = {}
    for b in batches:
        gen, first_only = SlowFastGenerator(lm, icfg), SlowFastGenerator(lm, InferenceConfig(
            max_new_tokens=1, cache_dtype="bfloat16"))
        text_b, audio_b = np.stack([text] * b), np.stack([audio] * b)

        def run(g, seed=SEED):
            gen_ = torch.Generator(device=dev).manual_seed(seed)
            if b == 1:
                a, t = g.generate(text, audio, gen_)
                return [a], [t]
            return g.generate_batched(text_b, audio_b, gen_)

        def timed(fn):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            res = fn()
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end), res

        run(first_only)  # cuBLAS and the allocator warm
        prefill_ms = min(timed(lambda: run(first_only))[0] for _ in range(3))
        first_ms, (a1, t1) = timed(lambda: run(gen))
        first_stats = dict(getattr(gen, "stats", {}))
        # a checkout without a captured loop has no first-call cost: its first generation is its steady one
        steady_ms, (a2, t2) = timed(lambda: run(gen)) if first_stats else (first_ms, (a1, t1))
        n = max(len(t) for t in t2)
        assert all(np.array_equal(x, y) for x, y in zip(a1 + t1, a2 + t2)), "one seed gave two answers"
        h = hashlib.sha256()
        for x in a2 + t2:
            h.update(np.ascontiguousarray(x, np.int64).tobytes())
        out[f"B={b} prefill ms"] = prefill_ms
        out[f"B={b} first generation ms"] = first_ms
        out[f"B={b} generation ms"] = steady_ms
        out[f"B={b} frames"] = n
        out[f"B={b} frames/s"] = (n - 1) / ((steady_ms - prefill_ms) / 1e3)
        out[f"B={b} frame ms"] = (steady_ms - prefill_ms) / (n - 1)
        out[f"own bits B={b}"] = h.hexdigest()
        for key in ("capture_s", "host_reads"):  # a checkout that captures its frame step reports these
            if key in getattr(gen, "stats", {}):
                out[f"B={b} {key}"] = gen.stats[key] if key == "host_reads" else first_stats[key]
        del gen, first_only
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ab", type=Path, help="another checkout, timed in turns with this one")
    ap.add_argument("--per-replay", help="frames per captured replay to sweep, e.g. 1,2,4,8 (this checkout)")
    ap.add_argument("--root", type=Path, default=HERE, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.per_replay:
        from dmel_codec_tpu_torch.lm import generate

        sweep = {}
        for k in map(int, args.per_replay.split(",")):
            generate.FRAMES_PER_GRAPH = k
            sweep[k] = time_here(args.root, batches=BATCHES[:2])
            print(f"FRAMES_PER_GRAPH = {k}: " + ", ".join(
                f"{case} {v:.4f}" for case, v in sweep[k].items() if not case.startswith("own bits")))
        print(json.dumps(sweep))
        return sweep
    if args.ab is None:
        times = time_here(args.root)
        print(json.dumps(times))
        return times

    runs = [args.ab, HERE, HERE, args.ab]
    table, bits = {}, {}
    for i, root in enumerate(runs):
        proc = subprocess.run([sys.executable, __file__, "--root", str(root.resolve())],
                              cwd=root, capture_output=True, text=True, timeout=1500)
        if proc.returncode != 0:
            raise RuntimeError(f"timing {root} failed:\n{proc.stderr[-4000:]}")
        times = json.loads(proc.stdout.strip().splitlines()[-1])
        for case, value in times.items():
            if case.startswith("own bits "):
                print(f"run {i + 1} {root}: {case}: sha256 {value[:16]}")
                bits.setdefault((case, str(root)), set()).add(value)
                continue
            print(f"run {i + 1} {root}: {case}: {value:.4f}")
            table.setdefault(str(root), {}).setdefault(case, []).append(value)
    for (case, root), hashes in bits.items():
        if len(hashes) != 1:
            raise AssertionError(f"{case} in {root}: the two runs gave different tokens")
        print(f"{case} in {root}: the same tokens in both of its runs")
    means = {root: {case: sum(v) / len(v) for case, v in cases.items()} for root, cases in table.items()}
    print(json.dumps(means))
    return means


if __name__ == "__main__":
    main()
