"""Build the CUDA kernels in `csrc/` with nvcc and load them with ctypes.

Each `csrc/<name>.cu` becomes one shared library with a plain `extern "C"`
interface, compiled for Hopper (`sm_90a`) on first use into `_build/`
(git-ignored) under a name that carries a digest of its sources and flags,
so an edited source is rebuilt and an unchanged one is loaded as it is.
Every launcher returns `cudaGetLastError()`; `check` turns a non-zero
code into an exception.  A build or launch failure raises: there is no
fallback to the plain versions.

The launch counts live here, one per kernel: each wrapper adds one where
it launches its kernel, and nowhere else.
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

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("epoch_sweep", "sha256", "records_root", "incremental", "bls_rlc",
           "bls_h2c", "bls_pairing", "bls_msm", "fr_batch", "g1_fft",
           "forkchoice", "bls_shard")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

launches = {"epoch_sweep": 0, "sha256_64B": 0, "records_root": 0,
            "records_root_gather": 0, "update_level": 0, "balance_chunks": 0,
            "proof_paths": 0, "bls_field_ops": 0, "rlc_scalar_mul": 0,
            "rlc_miller_product": 0, "final_exp_is_one": 0, "hash_to_g2": 0,
            "precomp_miller_product": 0, "msm_pippenger": 0,
            "msm_double_add": 0, "fr_field_ops": 0, "fr_barycentric": 0,
            "fr_coset_interpolate": 0, "fr_fft": 0, "g1_fft": 0,
            "fk20_hext": 0, "fc_apply": 0, "fc_refresh": 0, "fc_head": 0,
            "epoch_sweep_sharded": 0, "rlc_miller_shard": 0,
            "rlc_shard_combine": 0, "g1_shard_fold": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict:
    """Compile every library in `names` that is not built yet, one nvcc
    process per source, all started together.  Returns {name: seconds}
    for the sources compiled in this call; raises if any build fails."""
    BUILD_DIR.mkdir(exist_ok=True)
    todo = [n for n in names if not _target(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        tmp = _target(name).with_suffix(f".{os.getpid()}.tmp")
        log = open(BUILD_DIR / f"{name}.log", "w")
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
             str(CSRC / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT), tmp, log)
    seconds, failed = {}, []
    for name, (proc, tmp, log) in procs.items():
        rc = proc.wait()
        log.close()
        seconds[name] = time.perf_counter() - t0
        if rc == 0:
            os.replace(tmp, _target(name))
        else:
            failed.append(name)
    if failed:
        text = "\n".join((BUILD_DIR / f"{n}.log").read_text()
                         for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{text}")
    return seconds


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library for `csrc/<name>.cu` (building it if needed)."""
    build((name,))
    return ctypes.CDLL(str(_target(name)))


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError {err}")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, *tensors) -> None:
    """The kernel's input checks: every tensor on one CUDA device and
    contiguous (the kernels index rows by plain pointer arithmetic)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: all inputs must be on one CUDA "
                             f"device, got {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be 16-byte aligned")
