"""Launch counts of the hand-written kernels, one registry for all of them.

Each wrapper adds one to its kernel's count where it launches the kernel on
a CUDA tensor, and nowhere else (the plain versions on CPU tensors count
nothing). A run can so show that its main path went through the kernels:
``reset_launch_counts()`` just before it, ``launch_counts()`` just after.
"""

from __future__ import annotations

#: kernel launches per wrapper since the last ``reset_launch_counts()``
LAUNCHES = {"panel_update_vsweep": 0, "panel_vsweep": 0, "panel_usweep": 0,
            "fused_update_vsweep": 0, "masked_vsweep": 0, "masked_usweep": 0,
            "gj_solve": 0}


def count(name: str) -> None:
    LAUNCHES[name] += 1


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)
