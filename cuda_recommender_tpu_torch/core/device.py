"""Device selection for the port.

A CUDA device that is asked for and missing is an error: nothing here falls
back to the CPU. On CUDA, float32 matrix products run in full float32
(TF32 off), so the plain PyTorch versions of the kernels and the RMSE keep
the JAX package's f32 numerics. No other code changes a process-wide
matmul flag: a product in lower precision (the ALS gram at
``als_precision`` "high" or "default") takes it from its operands' dtype,
bf16, so an f32 product after it runs as before.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` (str or torch.device) -> torch.device, checked. Raises
    RuntimeError for a CUDA device when no GPU is present."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {str(device)!r} requested but "
                               "torch.cuda.is_available() is False")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r} (cuda or cpu)")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (no-op on the CPU, which runs
    eagerly)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
