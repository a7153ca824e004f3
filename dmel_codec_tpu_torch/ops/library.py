"""Build and bind the CUDA kernels in ../csrc.

At first use `load()` compiles every `csrc/*.cu` with nvcc for sm_90a, one
nvcc per source, all at once, and links the objects into one shared
library with a plain C interface, under `build/` at the root of the
checkout (named by a hash of the sources and flags, so an edited source
rebuilds), and binds it with ctypes. The compiler's resource report
(`-Xptxas -v`) is kept next to it. Nothing here runs at import time, and
there is no fallback: if the library cannot be built or loaded, `load()`
raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "dmel_anti_alias": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P],
    "dmel_act_conv_tf32": [
        _P, _P, _I, _I, _I, _I, _I, _P, _I, _P, _P, _I, _P, _P, _P, _F, _I, _I, _I, _I, _I, _P, _I, _P,
    ],
    "dmel_act_conv_tc": [
        _P, _I, _P, _I, _I, _I, _P, _I, _P, _P, _I, _P, _I, _P, _P, _I, _F, _I,
        _I, _I, _I, _I, _I, _P, _I, _P,
    ],
    "dmel_flash_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
    "dmel_flash_attention_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
    "dmel_flash_attention_bwd_dkv": [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P,
    ],
    "dmel_flash_attention_config": [_I, _I, _I, _I, _I, _P],
    "dmel_flash_attention_bwd_config": [_I, _I, _I, _I, _I, _I, _P],
    "dmel_sin_check": [_P, _P],
    "dmel_anti_alias_variant": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _I, _P],
    "dmel_stage_v1_tc": [
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _I, _P, _I, _P,
    ],
    "dmel_cf_act": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P],
    "dmel_rows_slice": [_P, _P, _I, _I, _I, _I, _P],
    "dmel_rows_roll": [_P, _P, _I, _I, _I, _I, _P],
    "dmel_tap_matmul": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "dmel_stage_v1_smem_bytes": [],
    "dmel_stage_conv_tf32": [_P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _F, _I, _I, _I, _I, _P],
    "dmel_fast_block": [_P] * 19 + [_I] * 7 + [_F, _P],
    "dmel_mla_attention": [_P] * 8 + [_I] * 7 + [_F, _P],
    "dmel_kda_scan": [_P] * 16 + [_I] * 6 + [_F, _P],
}


def find_nvcc() -> str | None:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    return str(cand) if cand.is_file() else shutil.which("nvcc")


def library_path() -> Path:
    sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources:
        h.update(p.name.encode() + p.read_bytes())
    return BUILD_DIR / f"libdmel_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the sources unless this exact build exists; returns the
    library path and the seconds spent compiling (0 when cached)."""
    out = library_path()
    if out.is_file():
        return out, 0.0
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
            "kernels cannot be built, and a CUDA tensor has no other path"
        )
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sorted(CSRC.glob("*.cu"))]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for src, obj in zip(sorted(CSRC.glob("*.cu")), objs)]
    logs, failed = [], []
    for proc in procs:
        _, err = proc.communicate()
        logs.append(err)
        if proc.returncode != 0:
            failed.append(f"{proc.args[-1]} ({proc.returncode}):\n{err}")
    if not failed:
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)], capture_output=True, text=True)
        if link.returncode != 0:
            failed.append(f"link ({link.returncode}):\n{link.stderr}")
    seconds = time.perf_counter() - t0
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    out.with_suffix(".log").write_text("".join(logs))
    os.replace(tmp, out)
    return out, seconds


@functools.cache
def load() -> ctypes.CDLL:
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.dmel_error_string.argtypes = [ctypes.c_int]
    lib.dmel_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: {lib.dmel_error_string(rc).decode()} ({rc})")


def check_plane(x: torch.Tensor, name: str = "x") -> None:
    """The kernels take contiguous, non-empty [B, C, T] float32/bfloat16
    tensors on a CUDA device."""
    if x.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 3 or x.numel() == 0:
        raise ValueError(f"{name} must be a non-empty [B, C, T] tensor, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """The attention kernel takes contiguous q [B, S, H, hd] and k, v
    [B, S, KH, hd] of one dtype (float32 or bfloat16) on one CUDA device,
    with H a multiple of KH and hd a multiple of 16 up to 128."""
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"q, k, v must lie on one CUDA device, got {q.device}, {k.device}, {v.device}")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share float32 or bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or q.numel() == 0:
        raise ValueError(f"q must be a non-empty [B, S, H, hd] tensor, got {tuple(q.shape)}")
    b, s, h, hd = q.shape
    if k.dim() != 4 or k.shape != v.shape or (k.shape[0], k.shape[1], k.shape[3]) != (b, s, hd):
        raise ValueError(f"k, v must be [B, S, KH, hd] beside q {tuple(q.shape)}, got {tuple(k.shape)}, {tuple(v.shape)}")
    kh = k.shape[2]
    if kh == 0 or h % kh:
        raise ValueError(f"{h} query heads are not a multiple of {kh} KV heads")
    if hd % 16 or hd > 128:
        raise ValueError(f"head size must be a multiple of 16 up to 128, got {hd}")
    if b > 65535 or h > 65535:
        raise ValueError(f"batch {b} and heads {h} must fit the launch grid (65535)")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k, v must start on a 16-byte boundary (the kernels copy 16 bytes at a time)")


def check_attention_grad(
    q: torch.Tensor, out: torch.Tensor, lse: torch.Tensor, grad: torch.Tensor
) -> None:
    """Beside q, k, v that passed `check_attention`, the backward kernels
    take the forward's output and the output's gradient, contiguous, of q's
    shape, dtype and device, and the forward's float32 log-sum-exp
    [B, H, S]."""
    b, s, h, _ = q.shape
    for name, t in (("out", out), ("grad", grad)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(
                f"{name} must be {tuple(q.shape)} {q.dtype} on {q.device}, "
                f"got {tuple(t.shape)} {t.dtype} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    if lse.shape != (b, h, s) or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(
            f"lse must be float32 {(b, h, s)} on {q.device}, got {tuple(lse.shape)} {lse.dtype} on {lse.device}"
        )
    if not lse.is_contiguous():
        raise ValueError("lse must be contiguous")


def channel_vector(p: torch.Tensor, like: torch.Tensor, n: int) -> torch.Tensor:
    """A per-channel parameter as a contiguous float32 vector beside `like`."""
    if p.shape != (n,) or p.device != like.device:
        raise ValueError(f"expected a [{n}] tensor on {like.device}, got {tuple(p.shape)} on {p.device}")
    return p.detach().to(torch.float32).contiguous()


def snake_parameters(alpha: torch.Tensor, beta, like: torch.Tensor, n: int):
    """K1's snake parameters as its kernels take them: alpha and beta (or
    None) as float32 vectors, and whether they are bf16 values (the kernel
    then rounds their exps and 1 / (beta + eps) to bf16, as the plain
    version's `snake_coefficients` computes them in bf16)."""
    dtypes = {alpha.dtype} | ({beta.dtype} if beta is not None else set())
    if not dtypes <= {torch.float32, torch.bfloat16} or len(dtypes) > 1:
        raise TypeError(f"alpha and beta must share float32 or bfloat16, got {sorted(map(str, dtypes))}")
    bt = None if beta is None else channel_vector(beta, like, n)
    return channel_vector(alpha, like, n), bt, int(alpha.dtype == torch.bfloat16)


def taps(filt: np.ndarray):
    return (ctypes.c_float * len(filt))(*filt.tolist())


def stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream
