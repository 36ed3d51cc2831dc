"""Build the CUDA sources under `csrc/` with nvcc and load them with ctypes.

Each kernel is one `.cu` file with a plain C entry point (no PyTorch
headers, so a build takes seconds). It is compiled on first use for
`sm_90a` into `build/` at the root of the checkout, under a name that
carries a hash of its source, the shared headers (`csrc/*.cuh`) and its
flags, so an edited source is rebuilt and a stale library is never
loaded. `build` starts one nvcc per source, all at once, and keeps each
build's nvcc output (ptxas's registers and spills) beside the library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: per-kernel flags; env_step's clock must round like the reference, so
#: nvcc may not contract a multiply and an add into one FMA there
EXTRA_FLAGS = {"env_step": ("-fmad=false",), "denoiser_chain": (),
               "denoiser_step": (), "flash_attention": (), "ssm_scan": (),
               "flash_attention_bwd": (), "ssm_scan_bwd": ()}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _flags(name: str):
    return BASE_FLAGS + EXTRA_FLAGS[name]


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha1(src + headers
                       + " ".join(_flags(name)).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{tag}.so"


def build(names: Iterable[str]) -> Dict[str, dict]:
    """Compile the named kernels that are not built yet, in parallel.

    Returns {name: {"seconds": wall time, "log": nvcc output}}; raises with
    nvcc's output when a compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists() and build_log_path(name).exists():
            continue   # a library without its log is built again
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *_flags(name), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    report = {}
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        build_log_path(name).write_text(log)
        os.replace(tmp, out)
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
    return report


def build_log_path(name: str) -> Path:
    """Where `build` kept the nvcc output of kernel `name`'s library."""
    return library_path(name).with_suffix(".log")


def raw_stream(device_index: int) -> int:
    """The current CUDA stream of a device as the address a launcher takes,
    without building a `torch.cuda.Stream` object (read as PyTorch's own
    kernel launchers read it)."""
    return torch._C._cuda_getCurrentRawStream(device_index)


def load(name: str) -> ctypes.CDLL:
    """The library of one kernel, built first if needed. Each wrapper
    loads its library once and keeps it."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))
