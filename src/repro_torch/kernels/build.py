"""Compile the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by nvcc
into ``build/repro_torch/lib<name>-<digest>.so`` at the repository root; the
digest covers the source and the flags, so an edited source is rebuilt.
`build` starts one nvcc per source, all at once.  Nothing is compiled when a
module is imported.

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false -std=c++17 \\
         -shared -Xcompiler -fPIC -Xptxas -v -o lib<name>.so csrc/<name>.cu
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-fmad=false",
    "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
KERNEL_SOURCES = ("page_counter", "tlb_walk", "rainbow_attention", "block_gather")

_LOADED: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The nvcc of CUDA_HOME, /usr/local/cuda, or PATH (raises if none)."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "build only on a machine with the CUDA toolkit")
    return found


def lib_path(name: str) -> Path:
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=KERNEL_SOURCES) -> dict[str, dict]:
    """Compile every named source that is not built yet, all nvcc's in parallel.

    Returns {name: {"seconds", "cached", "ptxas"}}; raises if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    out = {}
    t0 = time.perf_counter()
    for name in names:
        path = lib_path(name)
        if path.exists():
            out[name] = {"seconds": 0.0, "cached": True, "ptxas": ""}
            continue
        nvcc = nvcc or nvcc_path()
        tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    failed = []
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, path)
        out[name] = {"seconds": time.perf_counter() - t0, "cached": False,
                     "ptxas": log}
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


def library(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded shared library of csrc/<name>.cu, built first if needed.

    `signatures` maps each C function used to (argtypes, restype); pointers
    and the stream are ctypes.c_void_p so that 64-bit values pass whole.
    """
    lib = _LOADED.get(name)
    if lib is None:
        path = lib_path(name)
        if not path.exists():
            build((name,))
        lib = ctypes.CDLL(str(path))
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        for fn, (argtypes, restype) in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _LOADED[name] = lib
    return lib


def check_launch(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code (cudaGetLastError)."""
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")
