"""Training configuration.

The port's copy of ``cuda_recommender_tpu/core/config.py``: the same fields,
defaults and validation, so one ``Config`` means the same run in both
packages. It carries the semantic knob set of the reference's ``parameter``
class (reference src/pmf.h:8-43) and its CLI (reference
src/extras.cpp:68-141).

The port runs every knob of a run on one device or a mesh: CCD++ on the
``dense``, ``pallas``, ``hybrid`` (explicit bfloat16/int8 masks or
NaN-sentinel panels, the hand-written kernels) and ``ell`` backends at an
f32, bf16 or fp8 residual, the hybrid's rank-deferred tail
(``hybrid_defer_group``, one device), ALS on ``ell`` at every
``als_precision``, the NumPy ``ref`` backend, checkpoints and phase
timing. ``core/trainer.py`` raises only what the JAX package refuses too.

Reference quirks preserved deliberately:
  * ``maxinneriter`` defaults to 1 (the code default at src/pmf.h:31, not the
    help text's claimed 5 at src/extras.cpp:54).
  * ``eps`` is inert unless ``early_stop`` is set (the reference parses it
    and never reads it).
  * ``do_nmf`` (-N) clamps every rank-one update at 0 (the libpmf CCD++
    semantics the flag was copied from; dead in the reference).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class Solver(str, enum.Enum):
    CCD = "ccd"
    ALS = "als"


class Backend(str, enum.Enum):
    #: NumPy loop-faithful golden implementation (the reference-OMP role).
    REF = "ref"
    #: Dense-residual path (CCD).
    DENSE = "dense"
    #: Dense-residual path with the explicit-mask fused kernel (CCD).
    PALLAS = "pallas"
    #: Padded-ELL path (general sparse; the only compiled ALS path).
    ELL = "ell"
    #: Panel-hybrid path (CCD, single device): degree-sorted top users get
    #: dense residual panels, the light tail stays padded-ELL
    #: (solvers/ccd_hybrid.py).
    HYBRID = "hybrid"
    #: Dense for CCD when it fits, hybrid for larger matrices, ELL otherwise.
    AUTO = "auto"


@dataclasses.dataclass
class Config:
    # --- solver semantics (reference parity) ---
    solver: Solver = Solver.CCD            # -ALS flag flips to ALS
    k: int = 10                            # -k rank (src/pmf.h:27)
    maxiter: int = 5                       # -t outer iterations (src/pmf.h:30)
    maxinneriter: int = 1                  # -T inner iterations (src/pmf.h:31)
    lambda_: float = 0.1                   # -l regularization (src/pmf.h:33)
    eps: float = 1e-3                      # -e; inert unless early_stop is set
    #: Opt-in convergence stop: training ends once an outer iteration
    #: improves test RMSE by less than eps relative.
    early_stop: bool = False
    do_predict: bool = False               # -p; forces verbose (parity)
    verbose: bool = False                  # -q
    do_nmf: bool = False                   # -N; nonnegative CCD++ (libpmf semantics)
    threads: int = 4                       # -n; kept for parity

    # --- runtime knobs (replace nBlocks/nThreadsPerBlock) ---
    backend: Backend = Backend.AUTO
    golden: bool = False                   # run REF too and golden_compare
    seed: int = 0                          # factor init seed (reference: srand(0))
    residual_dtype: str = "float32"        # panel residual dtype ("bfloat16" ok)
    #: Outer iterations enqueued before the loop waits for their RMSE
    #: readbacks (solvers/pipeline.py). Per-iteration RMSE is still
    #: reported; only per-iteration wall-timing coarsens.
    fused_outer_iters: int = 1
    #: Phase-split telemetry: fenced add-back / sweeps / subtract per rank
    #: (the reference's per-phase timers, src/CCD.cpp:76-139).
    phase_timing: bool = False
    ell_min_width: int = 8                 # narrowest ELL bucket width (pow2)
    #: ALS bucket floor: a power of two, or "auto" (each side picks the
    #: largest floor in {128..8} that pads <= 1.3x its true nnz).
    als_min_width: int | str = "auto"
    #: Hybrid stair orientation: False = panels over top users x item
    #: prefixes; True = plan and run on the transposed matrix; "auto" =
    #: plan both and keep the smaller uncovered tail.
    hybrid_transpose: bool | str = False
    #: Per-group temp budget (MB) of the grouped ALS gram assembly.
    als_group_mb: int = 2048
    #: ALS gather tiling threshold (MB); 0 disables.
    als_gather_tile_mb: float = 32
    #: ALS gram-assembly matmul precision, as the JAX package's
    #: ``jax.lax.Precision`` on the TPU: "highest" = true f32 (one f32
    #: ``bmm``); "high" = bf16x3, the operands split into bf16 hi and lo
    #: and hi·hi + hi·lo + lo·hi summed in f32; "default" = one bf16 pass
    #: with f32 accumulation. The two bf16 forms run on the tensor cores
    #: (solvers/als_ell.py). A mesh runs "high" as "default", as the JAX
    #: package's sharded ALS does.
    als_precision: str = "highest"
    #: ALS k×k solve: "gj", "gj_xla" or "lax".
    als_solver: str = "gj"
    ell_chunk: int = 512                   # ALS gram scan chunk along the width axis
    eval_chunk: int = 1 << 20              # test-RMSE gather chunk
    dense_max_cells: int = 2_000_000_000   # AUTO picks DENSE below this m*n
    #: Hybrid backend: TOTAL cell budget for the dense panel stair (top
    #: users x all items, next users x top-w items, ...).
    hybrid_dense_cells: int = 2_000_000_000
    #: Widths (top-item counts) of the secondary dense panels; the first
    #: panel always spans all items. The planner searches the user
    #: boundaries per width to maximize covered nnz under the cell budget.
    #: "auto" chooses widths AND boundaries jointly from the degree
    #: distribution (solvers/ccd_hybrid._auto_stair).
    hybrid_panel_widths: tuple = "auto"
    #: Max distinct panel widths the auto stair may emit.
    hybrid_max_panels: int = 8
    #: Panel mask storage: "bfloat16" or "int8" ({0,1} mask arrays), or
    #: "nan": no mask array; unobserved panel cells hold a NaN sentinel in
    #: the residual (NaN + delta = NaN keeps them inert through updates; the
    #: sweeps read the mask as ~isnan).
    mask_dtype: str = "bfloat16"
    #: Run the hybrid backend's panel passes through the fused panel
    #: kernels (ops/panel_kernels.py): update + v-sweep partials in one
    #: read-modify-write pass, u-sweep partials in one read pass. Requires
    #: mask_dtype="nan".
    hybrid_panel_kernel: bool = False
    #: Rank-deferral group G for the hybrid ELL tail (0 = off).
    hybrid_defer_group: int = 0

    # --- io ---
    data_dir: Optional[str] = None         # positional data_dir (reference CLI)
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0              # 0 = off; else every N outer iters
    metrics_file: Optional[str] = None     # JSONL metrics sink

    def __post_init__(self) -> None:
        self.solver = Solver(self.solver)
        self.backend = Backend(self.backend)
        if self.do_predict:
            self.verbose = True            # src/extras.cpp:130-132
        if self.k <= 0:
            raise ValueError("rank k must be positive")
        if self.maxiter < 0 or self.maxinneriter <= 0:
            raise ValueError("iteration counts must be positive")
        if self.ell_min_width & (self.ell_min_width - 1):
            raise ValueError("ell_min_width must be a power of two")
        if isinstance(self.als_min_width, str):
            if self.als_min_width != "auto":
                raise ValueError("als_min_width must be 'auto' or a power "
                                 f"of two, got {self.als_min_width!r}")
        elif self.als_min_width & (self.als_min_width - 1):
            raise ValueError("als_min_width must be 'auto' or a power of two")
        if self.als_group_mb <= 0:
            raise ValueError("als_group_mb must be positive")
        if self.als_gather_tile_mb < 0:
            raise ValueError("als_gather_tile_mb must be >= 0 (0 disables)")
        if self.hybrid_transpose not in (False, True, "auto"):
            raise ValueError("hybrid_transpose must be False, True or "
                             f"'auto', got {self.hybrid_transpose!r}")
        if self.ell_chunk < 128 or (self.ell_chunk & (self.ell_chunk - 1)):
            raise ValueError("ell_chunk must be a power of two >= 128 (it "
                             "must divide every ELL bucket width)")
        if self.als_solver not in ("gj", "gj_xla", "lax"):
            raise ValueError(f"als_solver must be 'gj', 'gj_xla' or 'lax', "
                             f"got {self.als_solver!r}")
        if self.als_precision not in ("highest", "high", "default"):
            raise ValueError(f"als_precision must be 'highest', 'high' or "
                             f"'default', got {self.als_precision!r}")
        if self.residual_dtype not in ("float32", "bfloat16",
                                       "float8_e4m3fn"):
            raise ValueError(f"residual_dtype must be 'float32', 'bfloat16' "
                             f"or 'float8_e4m3fn', got "
                             f"{self.residual_dtype!r}")
        if self.mask_dtype not in ("bfloat16", "int8", "nan"):
            raise ValueError(f"mask_dtype must be 'bfloat16', 'int8' or "
                             f"'nan', got {self.mask_dtype!r}")
        if self.hybrid_panel_kernel and self.mask_dtype != "nan":
            raise ValueError("hybrid_panel_kernel requires mask_dtype='nan' "
                             "(the fused kernels read the mask from the "
                             "NaN sentinel)")
        if isinstance(self.hybrid_panel_widths, str):
            if self.hybrid_panel_widths != "auto":
                raise ValueError("hybrid_panel_widths must be a width tuple "
                                 f"or 'auto', got "
                                 f"{self.hybrid_panel_widths!r}")
        else:
            self.hybrid_panel_widths = tuple(
                int(w) for w in self.hybrid_panel_widths)
            if any(w <= 0 for w in self.hybrid_panel_widths):
                raise ValueError("hybrid_panel_widths must be positive")
        if self.hybrid_defer_group < 0:
            raise ValueError("hybrid_defer_group must be >= 0")
        if self.hybrid_max_panels <= 0:
            raise ValueError("hybrid_max_panels must be positive")

    def resolve_backend(self, m: int, n: int) -> Backend:
        """AUTO resolution: the dense-residual path for CCD when it fits,
        the panel-hybrid path for larger matrices, ELL otherwise. ALS has
        one compiled path (ELL), so an explicit dense, pallas or hybrid
        request normalizes to ELL."""
        if self.backend != Backend.AUTO:
            if (self.solver == Solver.ALS
                    and self.backend in (Backend.DENSE, Backend.PALLAS,
                                         Backend.HYBRID)):
                return Backend.ELL
            return self.backend
        if self.solver != Solver.CCD:
            return Backend.ELL
        if m * n <= self.dense_max_cells:
            return Backend.DENSE
        if self.hybrid_dense_cells // max(1, n) > 0:
            return Backend.HYBRID
        return Backend.ELL
