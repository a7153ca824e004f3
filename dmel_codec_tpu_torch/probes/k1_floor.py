"""K1's instruction-issue floor, counted from its SASS.

Compiles csrc/anti_alias.cu as the library does (nvcc for sm_90a) into a
cubin, disassembles it with `cuobjdump -sass`, and counts the instructions
the bf16 kernel issues per warp and unit of 32 x RUN outputs on its common
path: from the warp-uniform test that sends the unit to sin_reduced to the
16-byte stores of the unit before it (its down FIR runs a unit late),
leaving out the blocks an interior unit of a task skips (the halo steps at
a task's ends, sinf's slow path, the element-by-element stores of a row's
head and tail), and adding the up FIRs before the test. The floor at a shape is
that count times its units over what the card issues: 4 schedulers per SM,
one warp instruction each per clock, at the card's highest SM clock. It is
a floor: it takes every instruction at one issue slot (the conversion,
shuffle and integer pipes issue slower) and no stall.

    python -m dmel_codec_tpu_torch.probes.k1_floor

prints the counts by opcode and the floors at the main path's shapes; needs
nvcc, cuobjdump and a GPU (for the SM count and clock).
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
_LINE = re.compile(r"/\*([0-9a-f]{4,6})\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_]+)([.A-Z0-9_]*)\s*(.*?);")


def sass_of_full_bf16() -> list:
    """[(address, guard, opcode, modifiers, operands)] of K1's bf16 kernel
    (variant FULL)."""
    nvcc = library.find_nvcc()
    if nvcc is None:
        raise SystemExit("k1_floor: needs nvcc (and cuobjdump beside it)")
    with tempfile.TemporaryDirectory() as tmp:
        cubin = Path(tmp) / "k1.cubin"
        flags = [f for f in library.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
        subprocess.run([nvcc, *flags, "-cubin", "-o", str(cubin), str(library.CSRC / "anti_alias.cu")],
                       check=True, capture_output=True, text=True)
        sass = subprocess.run([str(Path(nvcc).with_name("cuobjdump")), "-sass", str(cubin)],
                              check=True, capture_output=True, text=True).stdout
    for func in re.split(r"\n\s+Function : ", sass)[1:]:
        name = func.split("\n", 1)[0]
        if "anti_alias_kernel" in name and "ILi0ELb1E" in name:  # <FULL, bf16>
            return [(int(m.group(1), 16), (m.group(2) or "").strip(), m.group(3), m.group(4), m.group(5))
                    for m in _LINE.finditer(func)]
    raise RuntimeError("no FULL bf16 K1 kernel in the SASS")


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


def main() -> dict:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("k1_floor: needs a GPU for its SM count and clock")
    path = common_path(sass_of_full_bf16())
    ops = collections.Counter(op for _, _, op, _, _ in path)
    per_unit = len(path)
    props = torch.cuda.get_device_properties(0)
    mhz = int(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, check=True).stdout.split()[0])
    rate = props.multi_processor_count * 4 * mhz * 1e6  # warp instructions per second
    print(f"{torch.cuda.get_device_name(0)}, {props.multi_processor_count} SMs at {mhz} MHz")
    print(f"common path: {per_unit} warp instructions per unit of {32 * RUN} outputs "
          f"({per_unit / RUN:.1f} per output and lane); by opcode: {dict(ops.most_common())}")

    def floor_ms(shapes):
        units = sum(n * b * c * -(-t // (32 * RUN)) for (b, c, t), n in shapes)
        return units * per_unit / rate * 1e3

    out = {"per_unit": per_unit, "per_output": per_unit / RUN, "request_ms": floor_ms(REQUEST),
           "window_ms": floor_ms(WINDOW), "s1_ms": floor_ms((((16, 384, 5952), 1),))}
    print(f"issue floor: s1 [16, 384, 5952] {out['s1_ms']:.4f} ms, per codec request {out['request_ms']:.4f} ms, "
          f"per streaming window {out['window_ms']:.4f} ms")
    return out


if __name__ == "__main__":
    main()
