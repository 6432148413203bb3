"""Builds the port's CUDA kernels and loads them with ``ctypes``.

Every ``src/repro_torch/csrc/*.cu`` compiles on first use, one ``nvcc``
per source started together, and links into
``build/torch_kernels/libwsfm_kernels.so`` at the root of the checkout.
The sources have a plain C interface (no PyTorch headers), so a build
takes seconds. There is no ``--use_fast_math``: the ``ws_step`` kernel's
Gumbel noise needs the accurate ``logf`` to match its plain version.

Each C entry point takes device pointers and the stream as ``void*`` and
returns ``cudaGetLastError()`` after its launch; :func:`check` raises on
a non-zero code. A failed build raises. ``launches`` and :func:`count`
come from :mod:`repro_torch.counts`: each wrapper counts its launch where
it launches.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

from repro_torch.counts import count, launches  # noqa: F401  (the wrappers' counting)

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
LIB_NAME = "libwsfm_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None
build_log = ""

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
_SIGNATURES = {
    # logits, x, a, out, rows, vocab, seed0, seed1, temperature, lanes a row (0: the
    # choice from vocab), stream
    "ws_step_launch": [_P, _P, _P, _P, _I, _I, _U, _U, _F, _I, _P],
    # logits, x, a, key (2,) int64 on the card, out, rows, vocab, temperature, lanes,
    # stream
    "ws_step_dkey_launch": [_P] * 5 + [_I, _I, _F, _I, _P],
    # logits, x, a (B,), keys (B, 2) int64, out, rows, vocab, group (N), temperature,
    # lanes a row, stream
    "ws_step_rows_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P],
    # vocab -> the lanes a row ws_step and ws_step_rows take for it
    "ws_step_lanes": [_I],
    # logits, x, a, gumbel, out, rows, padded vocab, valid vocab, temperature, lanes a
    # row (0: the choice from valid vocab), stream
    "ws_step_gumbel_launch": [_P] * 5 + [_I, _I, _I, _F, _I, _P],
    # logits, x, a (R / a_group,), key words k0, k1, out, rows, padded vocab, valid vocab,
    # a_group, temperature, lanes a row, stream
    "ws_step_gumbel_keyed_launch": [_P, _P, _P, _U, _U, _P] + [_I] * 4 + [_F, _I, _P],
    # logits, x, a, key (2,) int64 on the card, out, rows, padded vocab, valid vocab,
    # a_group, temperature, lanes a row, stream
    "ws_step_gumbel_dkey_launch": [_P] * 5 + [_I] * 4 + [_F, _I, _P],
    # logits, x, a (K, R / a_group), seeds (K, R / key_group, 2) int64, out, rows, vocab,
    # steps, key_group, a_group, temperature, lanes a row (0: the choice from vocab), stream
    "ws_fused_launch": [_P] * 5 + [_I] * 5 + [_F, _I, _P],
    # q, k, v, o, B, S, T, H, KH, DK (q and k's head_dim), DV (v and o's), scale, causal,
    # window (<= 0: none), stream
    "flash_attn_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P],
    # x, ln scale, ln bias, wq, wk, wv, bq, bk, bv, q, k cache, v cache, cursor,
    # R, S, T, D, H, KH, hd, pos0, norm, eps, use_rope, theta, stream
    "draft_qkv_rope_launch": [_P] * 13 + [_I] * 9 + [_F, _I, _F, _P],
    # q, k cache, v cache, cursor, out, R, S, T, H, KH, hd, pos0, cluster C, slice W,
    # scale, stream
    "draft_attn_cached_launch": [_P] * 5 + [_I] * 9 + [_F, _P],
    # a, x, wo, bo, ln scale, ln bias, wup, bup, wgate, bgate, wdown, bdown,
    # x1, u, out, R, D, H*hd, F, norm, eps, act, staged (1: every slice in stages), stream
    "draft_post_attn_launch": [_P] * 15 + [_I] * 5 + [_F, _I, _I, _P],
    # x, ln scale, ln bias, w, ldk, ldn, out, R, D, V, norm, eps, stream
    "draft_head_launch": [_P] * 4 + [_I, _I, _P] + [_I] * 4 + [_F, _P],
}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin; "
                       "the CUDA toolkit is needed to build the port's kernels")


def _stale(lib: Path, sources) -> bool:
    if not lib.exists():
        return True
    built = lib.stat().st_mtime
    return any(s.stat().st_mtime > built for s in sources)


def build(force: bool = False, ptxas_info: bool = False) -> Path:
    """Compile the kernels unless the library is newer than every source.

    ``ptxas_info`` adds ``-Xptxas -v`` (registers, shared memory and
    spills per kernel); the compiler's output is kept in ``build_log``.
    """
    global build_seconds, build_log
    sources = sorted(CSRC.glob("*.cu"))
    lib = BUILD_DIR / LIB_NAME
    if not force and not _stale(lib, sources + sorted(CSRC.glob("*.cuh"))):
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs = []
    for src in sources:
        obj = BUILD_DIR / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if ptxas_info else []),
               "-c", str(src), "-o", str(obj)]
        procs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors, logs = [], []
    for cmd, _, p in procs:
        out, _ = p.communicate()
        logs.append(f"$ {' '.join(cmd)}\n{out}")
        if p.returncode != 0:
            errors.append(logs[-1])
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    tmp = lib.with_suffix(f".so.tmp{os.getpid()}")
    cmd = [nvcc, *NVCC_FLAGS, "-shared", *[str(o) for _, o, _ in procs], "-o", str(tmp)]
    res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n$ {' '.join(cmd)}\n{res.stdout}")
    os.replace(tmp, lib)
    build_seconds = time.perf_counter() - t0
    build_log = "\n".join(logs)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.wsfm_error_string.argtypes = [ctypes.c_int]
            lib.wsfm_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        msg = library().wsfm_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")
