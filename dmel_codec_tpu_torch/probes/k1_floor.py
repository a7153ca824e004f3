"""The instruction-issue floors of K1 and of the probe P1, counted from
their SASS.

Compiles a source as the library does (nvcc for sm_90a) into a cubin,
disassembles it with `cuobjdump -sass`, and counts the instructions one
bf16 kernel issues per warp and unit of 32 x RUN outputs on its common
path: from the warp-uniform test that sends the unit to sin_reduced to the
16-byte stores of the unit before it (its down FIR runs a unit late),
leaving out the blocks an interior unit of a task skips (the halo steps at
a task's ends, sinf's slow path, the element-by-element stores of a row's
head and tail), and adding the up FIRs before the test. K1
(csrc/anti_alias.cu `anti_alias_kernel<FULL, bf16>`) and P1 (csrc/probes.cu
`cf_act_kernel<bf16>`) walk their units with the same code
(csrc/snake_units.cuh); P1 leaves out K1's edge rule and v rounding. The
floor at a shape is that count times its units over what the card issues:
4 schedulers per SM, one warp instruction each per clock, at the card's
highest SM clock. It is a floor: it takes every instruction at one issue
slot (the conversion, shuffle and integer pipes issue slower) and no stall.

    python -m dmel_codec_tpu_torch.probes.k1_floor

prints the counts by opcode and the floors at K1's main-path shapes and at
P1's timed shape; needs nvcc, cuobjdump and a GPU (for the SM count and
clock).
"""

from __future__ import annotations

import collections
import re
import subprocess
import tempfile
from pathlib import Path

from dmel_codec_tpu_torch.ops import library
from dmel_codec_tpu_torch.ops.anti_alias import RUN

# K1's bf16 shapes per codec request (launches) and per streaming window
REQUEST = (((16, 24, 95232), 1), ((16, 768, 1488), 18), ((16, 384, 5952), 18))
WINDOW = (((1, 24, 143360), 1), ((1, 768, 2240), 18), ((1, 384, 8960), 18))
P1_SHAPE = (16, 96, 24064)  # P1's timed shape (probes/cf_act.py SHAPES[0])
_LINE = re.compile(r"/\*([0-9a-f]{4,6})\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_]+)([.A-Z0-9_]*)\s*(.*?);")


def kernel_sass(source: str, kernel: str, args: str) -> list:
    """[(address, guard, opcode, modifiers, operands)] of the kernel of
    `csrc/<source>` whose mangled name holds `kernel` and the template
    arguments `args` (as mangled)."""
    nvcc = library.find_nvcc()
    if nvcc is None:
        raise SystemExit("k1_floor: needs nvcc (and cuobjdump beside it)")
    with tempfile.TemporaryDirectory() as tmp:
        cubin = Path(tmp) / "kernel.cubin"
        flags = [f for f in library.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
        subprocess.run([nvcc, *flags, "-cubin", "-o", str(cubin), str(library.CSRC / source)],
                       check=True, capture_output=True, text=True)
        sass = subprocess.run([str(Path(nvcc).with_name("cuobjdump")), "-sass", str(cubin)],
                              check=True, capture_output=True, text=True).stdout
    for func in re.split(r"\n\s+Function : ", sass)[1:]:
        name = func.split("\n", 1)[0]
        if kernel in name and args in name:
            return [(int(m.group(1), 16), (m.group(2) or "").strip(), m.group(3), m.group(4), m.group(5))
                    for m in _LINE.finditer(func)]
    raise RuntimeError(f"no {kernel} {args} in the SASS of {source}")


def sass_of_full_bf16() -> list:
    """K1's bf16 kernel (variant FULL)."""
    return kernel_sass("anti_alias.cu", "anti_alias_kernel", "ILi0ELb1E")  # <FULL, bf16>


def sass_of_p1_bf16() -> list:
    """P1's bf16 kernel."""
    return kernel_sass("probes.cu", "cf_act_kernel", "ILb1E")  # <bf16>


def _target(operands: str) -> int:
    return int(re.search(r"0x[0-9a-f]+", operands).group(0), 16)


def common_path(ins: list) -> list:
    """The instructions of one interior unit's common path (see the module
    doc): from the last shuffle of the x window through the warp-uniform
    test, then the fast path to the unit's 16-byte store, following
    unconditional branches and taking each conditional forward branch that
    skips a block an interior unit does not run: one that loads from device
    memory (a task's halo steps; an interior unit loads only before the
    test), calls sinf's slow path, or stores element by element."""
    at = {a: i for i, (a, *_) in enumerate(ins)}
    vote = next(i for i, x in enumerate(ins) if x[2] == "VOTE")
    bra = next(i for i in range(vote, len(ins)) if ins[i][2] == "BRA")
    start = max(i for i in range(vote) if ins[i][2] == "SHFL")
    path = ins[start:bra + 1]
    i = at[_target(ins[bra][4])]
    while not (ins[i][2] == "STG" and ins[i][3] == ".E.128"):
        a, guard, op, mod, opr = ins[i]
        path.append(ins[i])
        if op == "BRA" and not guard:
            i = at[_target(opr)]
            continue
        if op == "BRA" and _target(opr) > a:
            j = at[_target(opr)]
            skipped = ins[i + 1:j]
            if any(x[2] in ("LDG", "STL", "LDL", "CALL") or (x[2] == "STG" and x[3] != ".E.128") for x in skipped):
                i = j
                continue
        i += 1
    path.append(ins[i])
    return path


def issue_rate() -> float:
    """Warp instructions the card issues per second: 4 a clock on each SM,
    at its highest SM clock (nvidia-smi)."""
    import torch

    props = torch.cuda.get_device_properties(0)
    mhz = int(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, check=True).stdout.split()[0])
    print(f"{torch.cuda.get_device_name(0)}, {props.multi_processor_count} SMs at {mhz} MHz")
    return props.multi_processor_count * 4 * mhz * 1e6


def floor_ms(per_unit: int, shapes, rate: float) -> float:
    """The floor of `per_unit` warp instructions per unit over ((B, C, T),
    launches) pairs, at `rate` warp instructions per second."""
    units = sum(n * b * c * -(-t // (32 * RUN)) for (b, c, t), n in shapes)
    return units * per_unit / rate * 1e3


def count(what: str, sass: list) -> int:
    """The common path's warp instructions per unit of one kernel's SASS,
    printed by opcode."""
    path = common_path(sass)
    ops = collections.Counter(op for _, _, op, _, _ in path)
    print(f"{what} common path: {len(path)} warp instructions per unit of {32 * RUN} outputs "
          f"({len(path) / RUN:.1f} per output and lane); by opcode: {dict(ops.most_common())}")
    return len(path)


def main() -> dict:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("k1_floor: needs a GPU for its SM count and clock")
    rate = issue_rate()
    per_unit = count("K1", sass_of_full_bf16())
    out = {"per_unit": per_unit, "per_output": per_unit / RUN, "request_ms": floor_ms(per_unit, REQUEST, rate),
           "window_ms": floor_ms(per_unit, WINDOW, rate), "s1_ms": floor_ms(per_unit, (((16, 384, 5952), 1),), rate)}
    print(f"issue floor: s1 [16, 384, 5952] {out['s1_ms']:.4f} ms, per codec request {out['request_ms']:.4f} ms, "
          f"per streaming window {out['window_ms']:.4f} ms")
    p1_unit = count("P1", sass_of_p1_bf16())
    out["p1"] = {"per_unit": p1_unit, "per_output": p1_unit / RUN, "shape": list(P1_SHAPE),
                 "ms": floor_ms(p1_unit, ((P1_SHAPE, 1),), rate)}
    print(f"P1's issue floor at {list(P1_SHAPE)}: {out['p1']['ms']:.4f} ms")
    return out


if __name__ == "__main__":
    main()
