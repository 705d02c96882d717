"""Build and load the hand-written CUDA kernels (csrc/*.cu).

``nvcc`` compiles each source of ``csrc/`` for Hopper (``sm_90a``) into a
shared library of its own with a plain C interface, which ctypes loads:
``panel_kernels.cu`` (the CCD++ residual passes: K1-K3 over NaN-sentinel
panels, K4 and the masked sweeps over explicit-mask residuals, each at an
f32, bf16 or fp8 residual, and K1's integer-rounding probe),
``gj_kernels.cu`` (K5, the ALS batched solve), ``als_kernels.cu`` (the
ALS gram assembly) and ``probe_kernels.cu`` (the stream and gather
probes). The build happens at first
use, into ``cuda_recommender_tpu_torch/_build/`` (listed in .gitignore),
under a name keyed by the source's and the flags' hash, so an edited source
rebuilds and an unchanged one loads at once. ``build()`` starts one
``nvcc`` per missing library, all at once, and waits for them all. Each
build writes a per-process temporary file and renames it into place, so
concurrent processes never load a half-written library.

A missing ``nvcc`` or a failed compile raises: nothing falls back to the
plain PyTorch versions on a CUDA device.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_p, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_pi = ctypes.POINTER(ctypes.c_int)
#: library name -> {C function: argtypes}; every function returns the CUDA
#: error code of its launch (int, 0 = success)
SIGNATURES = {
    "panel_kernels": {
        # R, dtype, mask (None for the NaN sentinel), mask code, store
        # order, vectors, strip partials, g, h, rows, width, rows per
        # strip, stream
        "crtpu_update_vsweep": [_p, _i, _p, _i, _i, _p, _p, _p, _p, _p, _p,
                                _p, _p, _i, _i, _i, _p],
        "crtpu_vsweep": [_p, _i, _p, _i, _p, _p, _p, _p, _p, _i, _i, _i, _p],
        # R, dtype, mask, mask code, v, segment partials, group counters,
        # g, h, rows, width, row classes, runs, segments, groups
        # (row_sweep_plan), stream
        "crtpu_usweep": [_p, _i, _p, _i, _p, _p, _p, _p, _p, _p, _i, _i, _i,
                         _i, _i, _i, _p],
        # R, vectors, strip partials, g, h, rows, width, rows per strip,
        # stream (K1 rounded by integer RNE, bf16 only)
        "crtpu_update_vsweep_irne": [_p, _p, _p, _p, _p, _p, _p, _p, _p, _i,
                                     _i, _i, _p],
    },
    "gj_kernels": {
        # A, A's batch and row strides, b, b's strides, x, S, k, stream
        "crtpu_gj_solve": [_p, _ll, _ll, _p, _ll, _ll, _p, _ll, _i, _p],
    },
    "als_kernels": {
        # idx, val, counts, other, other's rows, out, partial grams (None
        # unless slots split), S, E, segment lanes, k, stream
        "crtpu_als_gram": [_p, _p, _p, _p, _ll, _p, _p, _ll, _i, _i, _i,
                           _p],
    },
    "probe_kernels": {
        # R, rows, width, stream
        "crtpu_stream_rmw": [_p, _i, _i, _p],
        # R, u (None: NaN-skip), range partials, tile counters, g, rows,
        # width, row path (aligned), ranges a tile (read_plan), stream
        "crtpu_stream_read": [_p, _p, _p, _p, _p, _i, _i, _i, _i, _p],
        # NaN-skip, aligned, out: the instance's resident blocks an SM
        "crtpu_stream_read_blocks": [_i, _i, _pi],
        # table, index, out, index rows, lanes, table rows, form, path
        # (L2, shared memory), stream
        "crtpu_gather": [_p, _p, _p, _ll, _i, _ll, _i, _i, _p],
        # device, out: opt-in shared memory a block, SMs
        "crtpu_gather_limits": [_i, _pi, _pi],
    },
}

_libs: dict = {}


def source(name: str) -> str:
    return os.path.join(_PKG, "csrc", f"{name}.cu")


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else ``$CUDA_HOME/bin/nvcc``
    (default CUDA_HOME: /usr/local/cuda). Raises RuntimeError when neither
    exists."""
    path = shutil.which("nvcc")
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    if path is None and os.path.exists(os.path.join(home, "bin", "nvcc")):
        path = os.path.join(home, "bin", "nvcc")
    if path is None:
        raise RuntimeError(f"nvcc not found (on PATH or in {home}/bin); the "
                           "kernels cannot be built")
    return path


def library_path(name: str) -> str:
    with open(source(name), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def build(names=None) -> dict:
    """Compile the libraries ``names`` (default: all) that are not built
    yet, one ``nvcc`` each, in parallel. Returns name -> (library path,
    compiler output: ptxas' register and shared-memory report; empty for a
    library that was already built)."""
    names = list(SIGNATURES if names is None else names)
    out = {name: (library_path(name), "") for name in names}
    missing = [name for name, (so, _) in out.items()
               if not os.path.exists(so)]
    if not missing:
        return out
    nvcc = nvcc_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in missing:
        so = out[name][0]
        tmp = f"{so}.tmp.{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, source(name)]
        procs[name] = (so, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for name, (so, tmp, cmd, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{log[-4000:]}")
            continue
        os.replace(tmp, so)
        out[name] = (so, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (built on first call), with every
    function's argtypes and restype set."""
    if name not in _libs:
        lib = ctypes.CDLL(build([name])[name][0])
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _libs[name] = lib
    return _libs[name]
