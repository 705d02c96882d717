"""Launch counts of the hand-written kernels, one registry for all of them.

Each wrapper adds one to its kernel's count where it launches the kernel on
a CUDA tensor, and nowhere else (the plain versions on CPU tensors count
nothing). A run can so show that its main path went through the kernels:
``reset_launch_counts()`` just before it, ``launch_counts()`` just after.

A CUDA graph's replay runs the kernels captured in it without calling their
wrappers, and the capture itself runs none of them: whoever replays a graph
adds its captured counts once per replay beyond the first
(``add_launches``; ``scripts/common.py::time_ms``).
"""

from __future__ import annotations

#: kernel launches per wrapper since the last ``reset_launch_counts()``
LAUNCHES = {"panel_update_vsweep": 0, "panel_vsweep": 0, "panel_usweep": 0,
            "fused_update_vsweep": 0, "masked_vsweep": 0, "masked_usweep": 0,
            "gj_solve": 0, "panel_update_vsweep_irne": 0, "stream_rmw": 0,
            "stream_read": 0, "gather": 0, "gather_smem": 0,
            # the fp8 instances of K1-K4 and the masked sweeps
            # (panel_kernels.instance_name)
            "panel_update_vsweep_fp8": 0,
            "panel_update_vsweep_fp8_delta_first": 0,
            "panel_vsweep_fp8": 0, "panel_usweep_fp8": 0,
            "fused_update_vsweep_fp8": 0,
            "fused_update_vsweep_fp8_delta_first": 0,
            "masked_vsweep_fp8": 0, "masked_usweep_fp8": 0}


def count(name: str) -> None:
    LAUNCHES[name] += 1


def add_launches(counts: dict) -> None:
    """Add ``counts`` (name -> launches): a CUDA graph replay's."""
    for name, n in counts.items():
        LAUNCHES[name] += n


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)
