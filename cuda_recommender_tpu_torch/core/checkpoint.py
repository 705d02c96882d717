"""Factor checkpointing and resume.

The port's copy of ``cuda_recommender_tpu/core/checkpoint.py``, semantics
unchanged, so a checkpoint written by either package loads in the other.
The reference has model (de)serialization but no mid-training checkpointing
(save calls commented out, reference src/main.cpp:146-149). This adds
per-outer-iteration atomic npz snapshots of the training state plus a
manifest, resumable across process restarts. CCD++ also snapshots its
residual: the residual is training state (src/CCD.cpp:100-134), so resuming
from factors alone would be wrong.

The payloads are numpy arrays made from tensors on the host; a bfloat16
tensor is widened to float32 before it gets here (``_native`` widens any
other non-native dtype, as the JAX package's ml_dtypes arrays are), and
the resume casts it back: both conversions are exact.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np


class Checkpointer:
    def __init__(self, directory: str, keep: int = 2):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _path(self, oiter: int) -> str:
        return os.path.join(self.dir, f"ckpt_{oiter:06d}.npz")

    @staticmethod
    def _native(arr: np.ndarray) -> np.ndarray:
        """npz silently stores non-native dtypes (e.g. ml_dtypes bfloat16) as
        raw void bytes that cannot be cast back on load — save them as f32."""
        arr = np.asarray(arr)
        if arr.dtype.kind not in "fiub":
            return arr.astype(np.float32)
        return arr

    def save(self, oiter: int, *, W: np.ndarray, H: np.ndarray,
             solver: str, backend: str, extra: Optional[dict] = None,
             meta: Optional[dict] = None) -> str:
        """``meta`` records the layout-determining knobs (k, num_shards, ELL
        min_width, ...): ELL payloads are slot-space and only valid under the
        exact slot permutation those knobs produced, so resume validates them
        (the solver/backend check alone would accept silently-wrong factors
        whenever shapes happen to coincide)."""
        arrays = {"W": self._native(W), "H": self._native(H)}
        for name, arr in (extra or {}).items():
            arrays[f"extra_{name}"] = self._native(arr)
        path = self._path(oiter)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)                      # atomic publish
        manifest = {"latest": oiter, "solver": solver, "backend": backend,
                    "meta": meta or {}, "file": os.path.basename(path)}
        mtmp = os.path.join(self.dir, "manifest.json.tmp")
        with open(mtmp, "w") as f:
            json.dump(manifest, f)
        os.replace(mtmp, os.path.join(self.dir, "manifest.json"))
        self._gc(oiter)
        return path

    def _gc(self, latest: int) -> None:
        snaps = sorted(f for f in os.listdir(self.dir)
                       if f.startswith("ckpt_") and f.endswith(".npz"))
        for f in snaps[:-self.keep]:
            os.remove(os.path.join(self.dir, f))

    def latest(self) -> Optional[dict]:
        """Returns {"oiter", "W", "H", "extra": {...}} or None."""
        mpath = os.path.join(self.dir, "manifest.json")
        if not os.path.exists(mpath):
            return None
        with open(mpath) as f:
            manifest = json.load(f)
        path = os.path.join(self.dir, manifest["file"])
        if not os.path.exists(path):
            return None
        with np.load(path) as z:
            out = {"oiter": int(manifest["latest"]),
                   "solver": manifest.get("solver"),
                   "backend": manifest.get("backend"),
                   "meta": manifest.get("meta", {}),
                   "W": z["W"], "H": z["H"], "extra": {}}
            for key in z.files:
                if key.startswith("extra_"):
                    out["extra"][key[len("extra_"):]] = z[key]
        return out
