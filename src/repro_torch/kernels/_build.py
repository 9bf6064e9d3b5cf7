"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles at first use with ``nvcc`` into its own
shared library with a plain C interface, loaded through ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/kernels/<name>-<digest>.so csrc/<name>.cu

The digest covers the sources and flags, so an edited kernel rebuilds and
an unchanged one loads from ``build/kernels/`` at the repository root (a
directory git ignores). :func:`build_all` starts one ``nvcc`` per source,
all at once. A failed build raises with the compiler's output. Every C
entry point returns ``cudaGetLastError()``; :func:`check` raises when it
is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
# -Xptxas -v: each kernel's registers, shared memory and spills in the log
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = ("paged_decode", "duet_attention_paged", "duet_attention",
           "flash_prefill", "sm_probe", "green_split")
# flags of one source beyond NVCC_FLAGS: the green contexts' shim and the
# warpgroup block's TMA tensor maps (cuTensorMapEncodeTiled) call the
# driver API
EXTRA_FLAGS = {"green_split": ["-lcuda"], "paged_decode": ["-lcuda"]}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# argtypes of each C entry point: every pointer and the stream as c_void_p
SIGNATURES = {
    "paged_decode": {
        "paged_decode_launch": [_P] * 6 + [_I] * 8 + [_F, _I, _I, _P],
        "paged_decode_occupancy": [_I] * 6 + [_P, _P],
    },
    "duet_attention_paged": {
        "duet_attention_paged_launch": [_P] * 7 + [_I] * 8 + [_F, _I, _P],
        "duet_attention_paged_occupancy": [_I] * 5 + [_P, _P],
    },
    "duet_attention": {
        "duet_attention_launch": [_P] * 7 + [_I] * 7 + [_F, _I, _P],
        "duet_attention_occupancy": [_I] * 4 + [_P, _P],
    },
    "flash_prefill": {
        "flash_prefill_launch": [_P] * 4 + [_I] * 8 + [_F, _I, _P],
        "flash_prefill_occupancy": [_I, _P],
    },
    "sm_probe": {
        "sm_probe_launch": [_P, _L, _P, _P, _I, _P],
        "sm_probe_occupancy": [_P],
    },
    "green_split": {
        "green_split_granularity": [_I, _P],
        "green_split_create": [_I, _I, _P],
        "green_split_destroy": [_P] * 4,
    },
}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (CUDA_HOME/bin/nvcc or PATH); the port's CUDA "
            "kernels are built from source at first use")
    return found


def _digest(name: str) -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS + EXTRA_FLAGS.get(name, [])).encode())
    return h.hexdigest()[:12]


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def _start_build(name: str):
    """Start nvcc for one source unless its library is already built.
    Returns (process, temporary output, final output) or None."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC / f"{name}.cu"), *EXTRA_FLAGS.get(name, [])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, started) -> str:
    """Wait for a started build; returns the compiler's output."""
    if started is None:
        return ""
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)   # atomic: concurrent builds agree
    return log


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every listed source in parallel (one nvcc each) unless
    already built. Returns each source's compiler output ("" when the
    library was already there)."""
    started = [(n, _start_build(n)) for n in names]
    return {n: _finish_build(n, st) for n, st in started}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish_build(name, _start_build(name))
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check(err: int, what: str):
    """Raise if a C entry point reported a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
