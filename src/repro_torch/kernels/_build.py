"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first use
with ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
-fPIC`` into ``build/repro_torch/<name>-<source hash>.so`` at the root of the
checkout, then loaded with ``ctypes``, its entry points typed once from
:data:`SIGNATURES`. A changed source gets a new hash and
so a new build. No fast-math: the kernels' epilogues must round exactly as
their plain versions do.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises on a non-zero code, since a launch CUDA refuses
never runs and a later synchronize would not report it.
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
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
# The C entry points of each source and their argument types; every entry
# point returns an int (its cudaGetLastError()).
SIGNATURES: Dict[str, Dict[str, list]] = {
    "timefloats_matmul": {
        # qx, sx, qw, sw, out, C, M, N, adc, fs, levels, step, stream
        "tf_matmul": [_P] * 5 + [_I] * 4 + [_F] * 3 + [_P]},
    "timefloats_matmul_transposed": {
        # qg, sg, qw, sw, out, D, M, C, stream
        "tf_matmul_t": [_P] * 5 + [_I] * 3 + [_P]},
    "sampling": {
        # lg, noise, temps, out, S, V, stream
        "sample_tokens": [_P] * 4 + [_I] * 2 + [_P]},
    "paged_gather": {
        # pool, pt, out, entries, P, page_bytes, vec_bytes, stream
        "gather_pages": [_P] * 3 + [_I] * 2 + [_L, _I, _P]},
    "paged_attn_gqa": {
        # q, kp, vp, pt, lengths, m, l, acc, out, B, H, Hkv, Dk, Dv, P,
        # page, ts, S, pt_stride, scale, pool_bf16, stream
        "paged_attn_gqa": [_P] * 9 + [_I] * 9 + [_L, _F, _I, _P],
        # G, Dk, span -> bytes of shared memory
        "paged_attn_gqa_smem": [_I] * 3},
}
SOURCES = tuple(SIGNATURES)  # every csrc/<name>.cu, built together

_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH)")
    return found


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Iterable[str]) -> float:
    """Compile every named source that has no current build, one nvcc per
    source, all started together. Returns the wall seconds spent."""
    t0 = time.monotonic()
    todo = [(n, _target(n)) for n in names if not _target(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.monotonic() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed,
    with its entry points' signatures declared."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)))
        for entry, argtypes in SIGNATURES[name].items():
            fn = getattr(lib, entry)
            fn.restype, fn.argtypes = ctypes.c_int, argtypes
        _LOADED[name] = lib
    return lib


def stream_ptr() -> ctypes.c_void_p:
    """PyTorch's current CUDA stream, for the launch."""
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
