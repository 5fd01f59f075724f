"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for ``sm_90a``,
all started together, and the objects are linked into ONE shared library
with a plain C interface, at first use, into ``coponerf_tpu_torch/_build/``
(git-ignored).  The library name carries a
hash of the sources and flags, so an edited source is never served by a
stale build.  Nothing here runs at import time, and nothing falls back: a
missing ``nvcc`` or a failed compile raises.

K2's bf16 kernel, K6 and K7a read through TMA descriptors.
``cuTensorMapEncodeTiled`` is a driver-API function: ``csrc/hopper.cuh``
fetches it once through the runtime's ``cudaGetDriverEntryPoint``, so
nothing links ``-lcuda``.

Each exported function takes device pointers and the CUDA stream as
``c_void_p`` and returns ``cudaGetLastError()`` after its launch; ``check``
turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo",
]

P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong
D = ctypes.c_double

# exported symbol -> argument types (pointers and the stream as c_void_p)
SIGNATURES = {
    # table (bf16), idx, w, out, B, HW, C, P, out_f32, stream
    "k1_corner_sample": [P, P, P, P, I, I, I, L, I, P],
    # grid, n_levels, 4 tables (bf16), 4 outs, (H, W, C) x 4, B, P, zeros_mode, out_f32, stream
    "k1_multilevel_sample": [P, I] + [P] * 8 + [I] * 12 + [I, L, I, I, P],
    # p0, p1, p2, pc, pt, W (bf16: (N, Kmm); f32: (Kmm, N)), W's tanh rows (3, N), bias,
    # fk (bf16: (NK, N); f32: (N, NK)), out, k, rows, K0, Kc, N, NK, dtype, stream
    "k2_split_dense_relu": [P] * 11 + [L, I, I, I, I, I, P],
    # pre, w, out, R, V, S, N, C, dtype, stream
    "k3_weighted_sum": [P, P, P, I, I, I, I, I, I, P],
    # g, idx, w, perm (i32 scratch, B x P), out (f32, zeroed), B, P, HW, C, g dtype, stream
    "k4_transpose_sample": [P, P, P, P, P, I, I, I, I, I, P],
    # c, xs, ys, xq, yq, row, col, scratch (f32), its floats, counters (i32), their count, B, Q, S, beta, stream
    "k5_soft_argmax_stats": [P, P, P, P, P, P, P, P, L, P, L, I, I, I, D, P],
    # B, Q, S -> floats of scratch that k5_soft_argmax_stats needs on the current device
    "k5_stats_scratch_floats": [I, I, I],
    # c, rowf, colf, dr, dcol, xs, ys, xq, yq, out, B, Q, S, beta, stream
    "k5_soft_argmax_bwd": [P, P, P, P, P, P, P, P, P, P, I, I, I, D, P],
    # ka, kbs, lc, fkb, wk2, bk2, wq, bq, wq2, bq2 (weights (in, out) f32), out, tokens, stream
    "k7_round1_logits": [P] * 11 + [L, P],
    # ze, lc, wq, bq, wq2, bq2, wra, wrb, br, wr2, br2 (weights (in, out) f32), out, B, V, S, N, stream
    "k7_round2_logits": [P] * 12 + [I, I, I, I, P],
    # 4 p levels, pt_p, 4 s levels, pt_s, lc, 21 weights and biases (W1 split into its transposed
    # matmul rows and its tanh rows; flva and flvb as one), z_sum, at_wt, scratch, scratch bytes,
    # B, V, S, N, G, stream
    "k6_render_core": [P] * 35 + [L, I, I, I, I, I, P],
    # B, V, S, N, G -> scratch bytes of one k6_render_core launch on the current device
    "k6_scratch_bytes": [I, I, I, I, I],
    # -> the most tokens a ray (V*S) that k6_render_core takes
    "k6_max_tokens": [],
}
RESTYPES = {"k6_scratch_bytes": ctypes.c_longlong, "k5_stats_scratch_floats": ctypes.c_longlong}

_lock = threading.Lock()
_lib = None
build_seconds = None


def _sources():
    return sorted(
        os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith((".cu", ".cuh"))
    )


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels can only be built where the CUDA toolkit is installed")


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libcoponerf_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels if no library for the current sources exists."""
    global build_seconds
    out = library_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(out):
                return out
            t0 = time.perf_counter()
            nvcc = _nvcc()
            tmp = out + f".tmp{os.getpid()}"
            objs, procs = [], []
            for src in (s for s in _sources() if s.endswith(".cu")):
                obj = f"{tmp}.{os.path.basename(src)}.o"
                objs.append(obj)
                procs.append((src, subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                )))
            failed = []
            for src, proc in procs:
                log, _ = proc.communicate()
                if proc.returncode != 0:
                    failed.append(f"{os.path.basename(src)} ({proc.returncode}):\n{log}")
            if failed:
                raise RuntimeError("nvcc failed: " + "\n".join(failed))
            res = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs],
                                 capture_output=True, text=True)
            for obj in objs:
                os.remove(obj)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
            os.replace(tmp, out)
            build_seconds = time.perf_counter() - t0
            return out
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = RESTYPES.get(name, ctypes.c_int)
            _lib = handle
        return _lib


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {code}")


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
