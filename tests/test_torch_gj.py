"""Port K5 (batched Gauss-Jordan solve) against the JAX package's kernel.

The same NumPy-seeded SPD systems (F Fᵀ + 3I, the systems of
tests/test_pallas.py:79-87) go through ``cuda_recommender_tpu/ops/
gj_pallas.py::gj_solve_pallas_bl`` (Pallas in interpret mode on the CPU, as
tests/test_pallas.py runs it; k = 128 takes its manual-DMA variant), the
JAX package's XLA ``gauss_jordan_solve``, and the port's
``gj_solve_plain``, which is the CUDA kernel's oracle on the card
(chip_smoke.py). Bars: port vs JAX rtol 1e-4, atol 1e-5 (the same
elimination; XLA may contract the update into an FMA, the port rounds the
product first); each within 5e-4 of np.linalg.solve in f64
(tests/test_pallas.py:87).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_recommender_tpu.ops.gj_pallas import gj_solve_pallas_bl
from cuda_recommender_tpu.solvers.als_ell import gauss_jordan_solve
from cuda_recommender_tpu_torch.ops import build, launches
from cuda_recommender_tpu_torch.ops import gj_kernels as gk


def _systems(k, S, seed):
    rng = np.random.default_rng(seed)
    F = rng.normal(size=(S, k, min(k, 16))).astype(np.float32)
    A = (np.einsum("sid,sjd->sij", F, F)
         + 3 * np.eye(k, dtype=np.float32)).astype(np.float32)
    b = rng.normal(size=(S, k)).astype(np.float32)
    return A, b


@pytest.mark.parametrize("k,S", [(1, 37), (6, 300), (40, 130), (128, 64)])
def test_gj_plain_matches_pallas_and_xla(k, S):
    A, b = _systems(k, S, seed=k * 1000 + S)
    x_pallas = np.asarray(gj_solve_pallas_bl(
        jnp.asarray(A.transpose(1, 2, 0)), jnp.asarray(b.T),
        interpret=jax.default_backend() == "cpu")).T
    x_xla = np.asarray(gauss_jordan_solve(jnp.asarray(A), jnp.asarray(b)))
    launches.reset_launch_counts()
    x = gk.gj_solve(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    assert launches.launch_counts()["gj_solve"] == 0     # CPU: plain version
    np.testing.assert_allclose(x, x_pallas, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(x, x_xla, rtol=1e-4, atol=1e-5)
    ref = np.linalg.solve(A.astype(np.float64),
                          b[..., None].astype(np.float64))[..., 0]
    np.testing.assert_allclose(x, ref, rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(x_pallas, ref, rtol=5e-4, atol=5e-4)


def test_wrapper_takes_plain_on_cpu_and_reads_strided_views():
    """A CPU tensor takes the plain version, bit for bit; A and b may be
    views of an augmented (S, k+1, k+1) gram, as the ALS assembly passes
    them."""
    A, b = _systems(7, 50, seed=1)
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    x = gk.gj_solve(At, bt)
    assert torch.equal(x, gk.gj_solve_plain(At, bt))
    aug = torch.zeros((50, 8, 8))
    aug[:, :7, :7], aug[:, :7, 7] = At, bt
    assert torch.equal(gk.gj_solve(aug[:, :7, :7], aug[:, :7, 7]), x)
    assert x.shape == (50, 7) and x.dtype == torch.float32
    assert gk.gj_solve(torch.zeros((0, 3, 3)), torch.zeros((0, 3))).shape \
        == (0, 3)


@pytest.mark.parametrize("bad", ["dtype", "b_dtype", "not_square",
                                 "b_shape", "ndim", "k_too_big", "k_zero",
                                 "columns_strided"])
def test_wrapper_validates_inputs(bad):
    A, b = torch.eye(4).repeat(3, 1, 1), torch.ones(3, 4)
    if bad == "dtype":
        A = A.double()
    elif bad == "b_dtype":
        b = b.to(torch.bfloat16)
    elif bad == "not_square":
        A = torch.zeros(3, 4, 5)
    elif bad == "b_shape":
        b = torch.ones(3, 5)
    elif bad == "ndim":
        A = torch.eye(4)
    elif bad == "k_too_big":
        A, b = torch.eye(129).repeat(2, 1, 1), torch.ones(2, 129)
    elif bad == "k_zero":
        A, b = torch.zeros(2, 0, 0), torch.zeros(2, 0)
    else:
        A = A.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises((TypeError, ValueError),
                       match="128" if bad == "k_too_big" else None):
        gk.gj_solve(A, b)


def _live_column_gj(A, b, width=None):
    """The elimination as csrc/gj_kernels.cu orders it, on the CPU: step i
    updates only the live columns i+1 .. k and the rhs (columns <= i are
    finished and never read again for x), with the plain version's
    roundings. With ``width`` the system is first padded to width × width
    as identity (zero extra rows and columns, a unit diagonal, a zero rhs)
    and all ``width`` steps run."""
    S, k = b.shape
    n = k if width is None else width
    M = torch.zeros((S, n, n + 1))
    M[:, :k, :k], M[:, :k, n] = A, b
    M[:, range(k, n), range(k, n)] = 1.0
    for i in range(n):
        prow = M[:, i, i + 1:] / M[:, i, i:i + 1]
        M[:, :, i + 1:] -= M[:, :, i:i + 1] * prow.unsqueeze(1)
        M[:, i, i + 1:] = prow
    return M[:, :k, n].contiguous()


@pytest.mark.parametrize("singular", [False, True])
@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("k", [1, 7, 8, 16, 17, 31, 32, 33, 40, 63, 64, 65,
                               128])
def test_live_columns_and_identity_padding_keep_the_bits(k, padded, singular):
    """The kernel's two invariants, bitwise against gj_solve_plain on ragged
    batches: updating only the live columns, and padding a system to a
    wider width (the next multiple of 8, or 8 more where k is one) as
    identity. A singular λ = 0 system (a zero gram) gives non-finite x in
    the same entries."""
    S = 29 + k % 7
    A, b = _systems(k, S, seed=k * 100 + S)
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    if singular:
        At[::3] = 0.0
    want = gk.gj_solve_plain(At, bt)
    width = (k + 7) // 8 * 8 if k % 8 else k + 8
    got = _live_column_gj(At, bt, width if padded else None)
    finite = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), finite)
    assert bool(finite.all()) != singular
    if singular:
        assert not bool(finite[::3].any())
    assert torch.equal(got[finite].view(torch.int32),
                       want[finite].view(torch.int32))


def test_plain_is_pivot_free_gauss_jordan():
    """The plain version is the JAX package's elimination step for step:
    on a 2x2 system its arithmetic can be written out."""
    A = torch.tensor([[[4.0, 2.0], [2.0, 3.0]]])
    b = torch.tensor([[2.0, 1.0]])
    x = gk.gj_solve_plain(A, b)
    # step 0: prow = [1, .5 | .5]; row1 = [2,3|1] - 2*prow = [0, 2 | 0]
    # step 1: prow = [0, 1 | 0]; row0 = [1, .5 | .5] - .5*prow = [1, 0 | .5]
    assert torch.equal(x, torch.tensor([[0.5, 0.0]]))


def test_build_knows_every_source_and_signature():
    """Every csrc/*.cu is built into a library of its own, and every
    exported C function is bound with one argtype per C parameter (ctypes
    would otherwise pass a pointer as a 32-bit int)."""
    import glob
    import os
    srcs = sorted(os.path.basename(p)[:-3] for p in glob.glob(
        os.path.join(os.path.dirname(build.source("gj_kernels")), "*.cu")))
    assert srcs == sorted(build.SIGNATURES)
    for name, fns in build.SIGNATURES.items():
        with open(build.source(name)) as f:
            text = f.read()
        c_api = text[text.index('extern "C" {'):]
        found = dict(re.findall(r"int (crtpu_\w+)\(([^)]*)\)", c_api))
        assert set(found) == set(fns), name
        for fn, argtypes in fns.items():
            assert len(found[fn].split(",")) == len(argtypes), fn
    assert build.library_path("gj_kernels") != build.library_path(
        "panel_kernels")


def test_one_launch_registry():
    """One registry counts every kernel, and one reset clears them all."""
    assert set(launches.launch_counts()) == {
        "panel_update_vsweep", "panel_vsweep", "panel_usweep",
        "fused_update_vsweep", "masked_vsweep", "masked_usweep", "gj_solve",
        "panel_update_vsweep_irne", "stream_rmw", "stream_read", "gather",
        "gather_smem",
        "panel_update_vsweep_fp8", "panel_update_vsweep_fp8_delta_first",
        "panel_vsweep_fp8", "panel_usweep_fp8", "fused_update_vsweep_fp8",
        "fused_update_vsweep_fp8_delta_first", "masked_vsweep_fp8",
        "masked_usweep_fp8"}
    launches.count("gj_solve")
    launches.count("panel_usweep")
    assert launches.launch_counts()["gj_solve"] == 1
    # a graph replay's launches: added per name
    launches.add_launches({"gather": 200, "gj_solve": 0})
    assert launches.launch_counts()["gather"] == 200
    assert launches.launch_counts()["gj_solve"] == 1
    launches.reset_launch_counts()
    assert set(launches.launch_counts().values()) == {0}
