"""cuda_recommender_tpu_torch — the PyTorch + CUDA port of cuda_recommender_tpu.

CCD++ matrix factorization on the panel-hybrid backend for one NVIDIA GPU:
degree-sorted dense residual panels driven by hand-written CUDA kernels
(csrc/panel_kernels.cu) plus a padded-ELL sparse tail, with the reference's
golden cross-check, per-iteration RMSE lines and CLI. The JAX package
``cuda_recommender_tpu`` is the reference this port is held against; this
package imports neither it nor jax.

Quick start::

    from cuda_recommender_tpu_torch import Config, train
    from cuda_recommender_tpu_torch.data.datasets import synthetic

    R, T = synthetic(m=6040, n=3706, nnz=900_000, seed=1)
    cfg = Config(k=10, maxiter=5, lambda_=0.05, backend="hybrid",
                 mask_dtype="nan", hybrid_panel_kernel=True, golden=True)
    result = train(cfg, R, T, device="cuda")
"""

from .core.config import Backend, Config, Solver          # noqa: F401
from .core.trainer import TrainResult, train              # noqa: F401

__version__ = "0.1.0"
