"""Build and load the hand-written CUDA kernels (csrc/*.cu).

``nvcc`` compiles ``csrc/panel_kernels.cu`` for Hopper (``sm_90a``) into a
shared library with a plain C interface, which ctypes loads. The build
happens at first use, into ``cuda_recommender_tpu_torch/_build/`` (listed in
.gitignore), under a name keyed by the source's and the flags' hash, so an
edited source rebuilds and an unchanged one loads at once. Each build writes
a per-process temporary file and renames it into place, so concurrent
processes never load a half-written library.

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
SOURCE = os.path.join(_PKG, "csrc", "panel_kernels.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None


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
                           "panel kernels cannot be built")
    return path


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR,
                        f"libpanel_kernels_{digest.hexdigest()[:16]}.so")


def build() -> tuple[str, str]:
    """Compile the kernels unless this source's library exists. Returns
    (library path, compiler output — ptxas' register and shared-memory
    report; empty when the library was already built)."""
    so = library_path()
    if os.path.exists(so):
        return so, ""
    tmp = f"{so}.tmp.{os.getpid()}"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, SOURCE]
    os.makedirs(BUILD_DIR, exist_ok=True)
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}): "
                           f"{' '.join(cmd)}\n{res.stderr[-4000:]}")
    os.replace(tmp, so)
    return so, res.stdout + res.stderr


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build()[0])
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.crtpu_panel_update_vsweep.argtypes = [p, i, p, p, p, p, p, p, p,
                                                  p, i, i, i, p]
        lib.crtpu_panel_vsweep.argtypes = [p, i, p, p, p, p, p, i, i, i, p]
        lib.crtpu_panel_usweep.argtypes = [p, i, p, p, p, i, i, p]
        for fn in (lib.crtpu_panel_update_vsweep, lib.crtpu_panel_vsweep,
                   lib.crtpu_panel_usweep):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
