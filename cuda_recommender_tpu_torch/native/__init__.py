"""Native (C++) host helpers: text parsing, ELL packing and grouping.

The port of ``cuda_recommender_tpu/native/``. The reference's only native
host code is its C++ program and loaders (reference src/*.cpp); the port
keeps Python as the host program and runs three data-preparation hot paths
through a small OpenMP C++ library bound with ctypes: the text-ratings
parser (``textparse``), the padded-ELL bucket fill (``ellfill``) and the
stable counting sort behind the dual CSR+CSC build and the hybrid panel
split (``groupsort``). The sources under ``src/`` are the JAX package's,
the same code (three comment lines cite the reference's files
differently). These are host code, not device kernels.

Each helper has a NumPy path with byte-identical results, taken when no
C++ toolchain is present (or inside ``numpy_only()``). Each call records
which path ran (``path_counts()``, and a ``logging`` INFO line the first
time each helper takes each path), so a run can show that its set-up went
native.

Build: ``python -m cuda_recommender_tpu_torch.native.build``, or at first
use when ``g++`` is present (about 2 s): ``g++ -O3 -shared -fPIC -fopenmp
-std=c++17`` into ``cuda_recommender_tpu_torch/_build/`` (listed in
.gitignore), under a name keyed by the sources' and flags' hash, written to
a per-process temporary name and renamed into place, so concurrent
processes (pytest workers, the ranks of a launch) never load a half-written
library.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import logging
import os
import subprocess

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
SOURCES = tuple(os.path.join(_DIR, "src", f)
                for f in ("textparse.cpp", "ellfill.cpp", "groupsort.cpp"))
FLAGS = ("-O3", "-shared", "-fPIC", "-fopenmp", "-std=c++17")

_log = logging.getLogger(__name__)
_lib = None
_numpy_only = False
#: calls per helper and path since the last ``reset_path_counts()``
PATHS = {helper: {"native": 0, "numpy": 0}
         for helper in ("textparse", "groupsort", "ellfill")}


def library_path() -> str:
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    for src in SOURCES:
        with open(src, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"libcrtpu_native_{digest.hexdigest()[:16]}.so")


def build_library(verbose: bool = False) -> str:
    """Compile the shared library unless it is built. Returns its path.
    Raises OSError when ``g++`` is missing or the compile fails. (The JAX
    package calls it ``build``, the name of this package's ``build``
    module, which would replace the function once imported.)"""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp.{os.getpid()}"
    res = subprocess.run(["g++", *FLAGS, "-o", tmp, *SOURCES],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise OSError(f"native build failed: {res.stderr[-2000:]}")
    os.replace(tmp, so)
    if verbose:
        print(f"[info] built {so}", flush=True)
    return so


def lib() -> ctypes.CDLL:
    """The loaded library (built on first use), every function's argtypes
    and restype set. Raises OSError if it cannot be built or loaded."""
    global _lib
    if _lib is not None:
        return _lib
    L = ctypes.CDLL(build_library())
    i64, i32, f32, c = (ctypes.POINTER(ctypes.c_int64),
                        ctypes.POINTER(ctypes.c_int32),
                        ctypes.POINTER(ctypes.c_float), ctypes.c_int64)
    L.crtpu_count_lines.restype = ctypes.c_longlong
    L.crtpu_count_lines.argtypes = [ctypes.c_char_p]
    L.crtpu_parse_ratings.restype = ctypes.c_longlong
    L.crtpu_parse_ratings.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                      ctypes.c_longlong, i64, i64, f32]
    L.crtpu_ell_fill.restype = None
    L.crtpu_ell_fill.argtypes = [i64, i32, f32, i32, i64,
                                 c, c, c, c, c, c, ctypes.c_int32, i32, f32]
    L.crtpu_key_count.restype = None
    L.crtpu_key_count.argtypes = [i32, c, c, i64]
    L.crtpu_stable_perm.restype = None
    L.crtpu_stable_perm.argtypes = [i32, c, c, i64, i64]
    L.crtpu_perm_gather.restype = None
    L.crtpu_perm_gather.argtypes = [i64, c, i32, f32, i32, f32]
    _lib = L
    return L


def available() -> bool:
    """Whether the native path runs: the library builds and loads, and no
    ``numpy_only()`` block is open."""
    if _numpy_only:
        return False
    try:
        lib()
        return True
    except OSError:
        return False


@contextlib.contextmanager
def numpy_only():
    """Run the helpers' NumPy paths inside the block (the native path's
    yardstick: ``scripts/host_setup.py``, the tests)."""
    global _numpy_only
    before, _numpy_only = _numpy_only, True
    try:
        yield
    finally:
        _numpy_only = before


def record(helper: str, path: str) -> None:
    """Count one call of ``helper`` on ``path`` ("native" or "numpy"); the
    first of each pair since the last reset is logged (INFO)."""
    PATHS[helper][path] += 1
    if PATHS[helper][path] == 1:
        _log.info("%s: %s path", helper, path)


def reset_path_counts() -> None:
    for counts in PATHS.values():
        for path in counts:
            counts[path] = 0


def path_counts() -> dict:
    return {helper: dict(counts) for helper, counts in PATHS.items()}
