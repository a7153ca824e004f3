"""Build at first use and bind with ctypes: the host C++ decode kernels
(`audio_kernels.cpp`, RIFF decode, Kaiser polyphase resampling, peak
normalization) of the data loader.

`load_library()` compiles the source with the host compiler (`$CXX`, else
g++; `-O3 -shared -fPIC -std=c++17`, first with `-march=native`) into
`build/` at the root of the checkout, the directory that holds the CUDA
library (`ops/library.py`). The file is named by a hash of the source and of
the host CPU's instruction-set flags (`-march=native` code must not run on
another CPU that a copied checkout lands on), so an edited source or another
host rebuilds, and it is written under a temporary name and renamed into
place, so that processes building at once (the test workers, the ranks
of a data-parallel run) never load a half-written file. ctypes releases the
GIL for the whole call, which lets the loader's decode threads run on all
cores. No CUDA and no PyTorch header is involved.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

SRC = Path(__file__).resolve().parent / "audio_kernels.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_ERROR: Optional[str] = None

_C, _D, _I, _L, _F = ctypes.c_char_p, ctypes.c_double, ctypes.c_int, ctypes.c_long, ctypes.c_float
_SIGNATURES = {
    "dmel_wav_info": (_I, [_C, ctypes.POINTER(_I), ctypes.POINTER(_L), ctypes.POINTER(_I)]),
    "dmel_load_len": (_L, [_C, _D, _D, _I]),
    "dmel_load_wav": (_L, [_C, _D, _D, _I, _F, ctypes.POINTER(_F), _L]),
}


def _host_flags() -> bytes:
    """The CPU's instruction-set flags (the first `flags` line of
    /proc/cpuinfo), else the architecture's name."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith(b"flags"):
                    return line
    except OSError:
        pass
    return platform.machine().encode()


def library_path() -> Path:
    """Where the library for the current source and host lives."""
    tag = hashlib.sha256(SRC.read_bytes() + _host_flags()).hexdigest()[:16]
    return BUILD_DIR / f"audio_kernels_{tag}.so"


def build() -> Path:
    """Compile the source unless its library is already there; returns its path.
    Raises `RuntimeError` with the compiler's output when it fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cxx = os.environ.get("CXX", "g++")
    fd, tmp = tempfile.mkstemp(prefix=out.stem + ".", suffix=".tmp", dir=BUILD_DIR)
    os.close(fd)
    errors = []
    try:
        for arch in (["-march=native"], []):  # -march=native vectorizes the decode and FIR loops
            cmd = [cxx, "-O3", *arch, "-shared", "-fPIC", "-std=c++17", str(SRC), "-o", tmp]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True)
            except OSError as e:  # no such compiler
                errors.append(f"{' '.join(cmd)}: {e}")
                continue
            if proc.returncode == 0:
                os.replace(tmp, out)  # atomic: concurrent builds race safely
                return out
            errors.append(f"{' '.join(cmd)}:\n{proc.stderr[-2000:]}")
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    raise RuntimeError("could not build the native audio kernels:\n" + "\n".join(errors))


def load_library() -> ctypes.CDLL:
    """Build (once per process) and load the kernels. Raises `RuntimeError`
    when they cannot be built or loaded; the failure is remembered, so later
    calls raise at once."""
    global _LIB, _ERROR
    with _LOCK:
        if _LIB is None and _ERROR is None:
            try:
                lib = ctypes.CDLL(str(build()))
            except (OSError, RuntimeError) as e:
                _ERROR = str(e)
            else:
                for name, (restype, argtypes) in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.restype, fn.argtypes = restype, argtypes
                _LIB = lib
        if _LIB is None:
            raise RuntimeError(_ERROR)
        return _LIB


def native_available() -> bool:
    try:
        load_library()
    except RuntimeError:
        return False
    return True
