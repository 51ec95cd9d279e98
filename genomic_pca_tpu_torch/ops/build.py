"""Build and load the hand-written CUDA kernels of `csrc/`.

The sources compile with nvcc into one shared library with a plain C
interface, loaded with ctypes (no PyTorch headers, so a build takes
seconds).  Each `.cu` compiles in its own nvcc process, all started
together, and one more nvcc links the objects.  The library lands in
`build/kernels/<source hash>/` under the checkout and is built at first
use; a later process with the same sources loads it without rebuilding.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

log = logging.getLogger(__name__)

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argument types.  Every entry returns the
# launch's cudaGetLastError() as an int (the plans, which launch nothing,
# 0).
SIGNATURES = {
    "gp_left2d_plan": [_I, _I, _I, _I, _P],
    "gp_right2d_plan": [_I, _I, _I, _I, _P],
    "gp_q8_right2d_plan": [_I, _I, _I, _I, _P],
    "gp_q8_left2d_plan": [_I, _I, _I, _I, _I, _P],
    "gp_q8_pass_plan": [_I, _I, _I, _I, _I, _P],
    "gp_gram_plan": [_I, _I, _I, _I, _I, _P],
    "gp_tsq_plan": [_I, _I, _I, _I, _I, _P],
    "gp_wtw_plan": [_I, _I, _I, _P],
    "gp_right_narrow_plan": [_I, _I, _I, _I, _I, _P],
    "gp_right_narrow_packed": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "gp_right_narrow_dense": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "gp_right2d_packed": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "gp_right2d_dense": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "gp_right2d_w_packed": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "gp_right2d_w_dense": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "gp_gram_packed": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "gp_gram_dense": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "gp_tsq_packed": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "gp_tsq_dense": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "gp_wtw_mma": [_P, _P, _P, _I, _I, _I, _I, _P],
    "gp_right_packed": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "gp_left_packed": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "gp_wtw": [_P, _P, _I, _I, _I, _I, _P],
    "gp_left2d_packed": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "gp_q8_right2d": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "gp_q8_left2d": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "gp_right_dense": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "gp_left_dense": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "gp_left2d_dense": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "gp_q8_right2d_dense": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "gp_q8_left2d_dense": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "gp_q8_pass_packed": [_P] * 9 + [_I] * 6 + [_P],
    "gp_q8_pass_dense": [_P] * 9 + [_I] * 6 + [_P],
    "gp_standardize_runs_packed": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "gp_standardize_runs_dense": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def sources() -> list:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = shutil.which("nvcc")
    if cand is None and CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
    if cand is None or not os.path.exists(cand):
        raise RuntimeError(
            "nvcc not found (PATH and CUDA_HOME): the CUDA kernels of "
            "genomic_pca_tpu_torch are built from source at first use."
        )
    return cand


def build(force: bool = False) -> tuple:
    """Compile `csrc/*.cu` into the hashed build directory.

    Returns (library path, seconds spent, compiler log).  Reuses an
    existing library for the same sources unless `force`."""
    out_dir = BUILD_ROOT / source_hash()
    lib_path = out_dir / "libgp_kernels.so"
    if lib_path.exists() and not force:
        return lib_path, 0.0, ""
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    tmp = out_dir / f"libgp_kernels.{tag}.so"
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in sorted(CSRC.glob("*.cu")):
        obj = out_dir / f"{src.stem}.{tag}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    logs = [p.communicate()[0] for p in procs]
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs), "-ldl"],
        capture_output=True, text=True,
    ) if all(p.returncode == 0 for p in procs) else None
    secs = time.perf_counter() - t0
    text = "".join(logs) + (link.stdout + link.stderr if link else "")
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link is None or link.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{text}")
    (out_dir / "nvcc.log").write_text(text)
    os.replace(tmp, lib_path)  # atomic: concurrent builders never see half a file
    log.info("Built CUDA kernels in %.1fs -> %s", secs, lib_path)
    return lib_path, secs, text


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            path, _, _ = build()
            handle = ctypes.CDLL(str(path))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib
