"""One run of one benchmark cell of dmel_codec_tpu_torch on one machine.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It builds the cell's program from
`benchmark/workloads/<cell>.json` and its configuration, makes weights and
inputs on the card from the seed, warms up every shape the traffic uses
(`setup_s`), then runs a closed loop for `--seconds` and prints, as the last
line of standard output, one JSON object: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics, or with `--trace 1` its per-layer
metrics from the traced slice), `device`, with `--trace 1` `breakdown`,
and last `checks`, each number compared with the plain reference beside
its limit. The same checks are the last lines of standard error.

It exits non-zero, printing no result, without a CUDA device (or with
fewer than the cell asks for), outside a checkout of the program, or when
the process holds a module of jax, jaxlib, flax or the JAX package once the
window has closed.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "dmel_codec_tpu")


def _environment() -> None:
    """Kernel caches at fixed paths inside the checkout; no framework that
    a library might load JAX through."""
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list:
    """Modules in this process whose top-level name, compared whole, is one
    the benchmark may not load."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def result_line(cell, out: dict, kind: str) -> dict:
    """The result's JSON object from a run_cell's output; `checks` last."""
    from benchmark.harness import runner

    run = out["run"]
    result = {
        "correct": runner.correct(out["checks"]),
        "attempted": len(run.records),
        "failed": 0,
        "metrics": out["metrics"],
        "device": {
            "platform": "gpu",
            "kind": kind,
            "count": cell.chips,
            "memory_peak_bytes": int(out["memory_peak"]),
            "power_limit_w": run.power_limit_w,
        },
    }
    if run.trace is not None:
        result["device"]["busy_s"] = run.trace.busy_s()
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.top_ops(10), "idle_gaps": run.trace.idle_gaps(10)}
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in out["checks"]}
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    _environment()

    from benchmark.harness import spec

    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    try:
        import dmel_codec_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"not a checkout of the program: {e}", file=sys.stderr)
        return 2

    from benchmark.harness import runner

    device = torch.device("cuda", 0)
    out = runner.run_cell(cell, args.seed, args.seconds, bool(args.trace), device, _T0)
    run = out["run"]
    found = forbidden_modules()
    if found:
        print(f"the process holds forbidden modules: {found}", file=sys.stderr)
        return 3
    result = result_line(cell, out, torch.cuda.get_device_name(device))
    if run.trace is not None:
        print(f"traced slice: {len(run.traced)} units, {len(run.trace.ops)} device ops "
              f"({run.trace.kernels()} kernels, {run.trace.unlinked} with no launch found), "
              f"{run.trace.window_s:.4f} s, read in {run.trace.read_s:.1f} s; card power limit {run.power_limit_w} W",
              file=sys.stderr)
    for c in out["checks"]:
        print(f"check {c['name']}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
