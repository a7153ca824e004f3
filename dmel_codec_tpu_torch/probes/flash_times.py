"""Times of the flash-attention kernels FA, FA-dKV and FA-dQ at the LM's
main-path shapes, and a same-card comparison of two checkouts' kernels.

    python3 -m dmel_codec_tpu_torch.probes.flash_times              # this checkout
    python3 -m dmel_codec_tpu_torch.probes.flash_times --ab OTHER   # OTHER, this, this, OTHER

With `--ab` each run is its own process (this file run as a script from
the checkout's root) that imports the port from its checkout, builds that checkout's kernels from its own `csrc/` (into its
`build/`), and times them through its `ops/flash_attention.py` (both must
have `_launch(q, k, v, with_lse)`, `flash_attention_dkv(q, k, v, grad, lse,
delta)` and `flash_attention_dq(...)`); the runs alternate so that a drift
of the card shows as a difference between the two runs of one checkout.
Prints one line per shape and run, and as its last line a JSON object
{checkout: {case: ms per launch, mean of its runs}}.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
# (name, B, S, H, KH, hd, dtype): the LM forward's bf16 [2, 2048] and the
# trainer's float32 [2, 1024] (plus its backward at [2, 2048] in both types)
CASES = [("fwd", 2, 2048, 14, 2, 64, "bfloat16"), ("fwd+L", 2, 1024, 14, 2, 64, "float32"),
         ("bwd", 2, 1024, 14, 2, 64, "float32"), ("bwd", 2, 2048, 14, 2, 64, "float32"),
         ("bwd", 2, 2048, 14, 2, 64, "bfloat16")]


def time_here(root: Path, reps: int = 20) -> dict:
    """ms per launch of the checkout at `root`, keyed "FA bfloat16 [2, 2048]" etc."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("flash_times: the probe times CUDA kernels and needs a GPU")
    sys.path.insert(0, str(root))
    from dmel_codec_tpu_torch.ops import flash_attention as fa

    def cuda_ms(fn, n):  # CUDA events over n launches after one warm-up
        fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    assert Path(fa.__file__).resolve().is_relative_to(root.resolve()), fa.__file__
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    with torch.no_grad():
        for name, b, s, h, kh, hd, dt in CASES:
            dtype = getattr(torch, dt)
            q, k, v, g = (torch.randn((b, s, n, hd), device="cuda", generator=gen).to(dtype)
                          for n in (h, kh, kh, h))
            tag = f"{dt} [{b}, {s}]"
            if name == "fwd":
                out[f"FA {tag}"] = cuda_ms(lambda: fa._launch(q, k, v), reps)
            elif name == "fwd+L":
                out[f"FA storing L {tag}"] = cuda_ms(lambda: fa._launch(q, k, v, with_lse=True), reps)
            else:
                o, lse = fa._launch(q, k, v, with_lse=True)
                delta = (g.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
                out[f"FA-dKV {tag}"] = cuda_ms(lambda: fa.flash_attention_dkv(q, k, v, g, lse, delta), reps)
                out[f"FA-dQ {tag}"] = cuda_ms(lambda: fa.flash_attention_dq(q, k, v, g, lse, delta), reps)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ab", type=Path, help="another checkout, timed in turns with this one")
    ap.add_argument("--root", type=Path, default=HERE, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.ab is None:
        times = time_here(args.root)
        print(json.dumps(times))
        return times
    runs = [args.ab, HERE, HERE, args.ab]
    table = {}
    for i, root in enumerate(runs):
        proc = subprocess.run([sys.executable, __file__, "--root", str(root.resolve())],
                              cwd=root, capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"timing {root} failed:\n{proc.stderr[-4000:]}")
        times = json.loads(proc.stdout.strip().splitlines()[-1])
        for case, ms in times.items():
            print(f"run {i + 1} {root}: {case}: {ms:.4f} ms")
            table.setdefault(str(root), {}).setdefault(case, []).append(ms)
    means = {root: {case: sum(v) / len(v) for case, v in cases.items()} for root, cases in table.items()}
    print(json.dumps(means))
    return means


if __name__ == "__main__":
    main()
