"""Readings for the limits of `correct`: the program's numbers over many
seeds, and the controls' (the reference one precision below the
configuration, and each fault the cell can have, in the program's place).

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,3 --seconds 3 [--controls]

One process, one set-up a seed; each seed runs a short window at the cell's
own size and load, then prints one JSON line: {"seed", "program": {name:
value}, "<control>": {name: value}, ...}. The benchmark's runs never run
the controls; this tool and benchmark/tests/test_control.py do.
"""

import argparse
import gc
import json
import sys
import time

from benchmark.run import _environment


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--controls", action="store_true")
    args = parser.parse_args(argv)
    _environment()
    import torch

    from benchmark.harness import runner, spec

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available():
        print("calibration reads the card: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        drv = spec.driver(cell.workload["driver"]).Driver(cell, seed, device)
        drv.setup()
        records = runner.window(drv, args.seconds, None, None)
        drv.release()
        gc.collect()
        torch.cuda.empty_cache()
        line = {"seed": seed, "units": len(records)}
        line["program"] = {c["name"]: c["value"] for c in drv.check(records)}
        if args.controls:
            for control in drv.controls:
                line[control] = {c["name"]: c["value"] for c in drv.check(records, control=control)}
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del drv
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
