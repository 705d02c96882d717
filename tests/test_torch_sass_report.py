"""The SASS report of the sweep kernels (scripts/sass_report.py): its
parsers on canned ptxas and cuobjdump text, its per-cell counts, and its
exit without the CUDA toolkit."""

import json
import re

import pytest

from cuda_recommender_tpu_torch.ops import build
from cuda_recommender_tpu_torch.scripts import sass_report as sr

MANGLED = ("_ZN49_GLOBAL__N__a6a80a67_16_panel_kernels_cu_7ce201e416col_sweep"
           "_kernelINS_3Fp8EaLb1ENS_8RoundCvtENS_15StoreDeltaFirstEEEvPT_PKT0"
           "_PKfSA_SA_SA_PfSB_iii")

PTXAS = f"""ptxas info    : Compiling entry function '{MANGLED}' for 'sm_90a'
ptxas info    : Function properties for {MANGLED}
    16 bytes stack frame, 12 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 16 bytes cumulative stack size, 16384 bytes smem
ptxas info    : Compiling entry function '_Z3foov' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 0 barriers
"""

SASS = f"""
	code for sm_90a
		Function : {MANGLED}
	.headerflags	@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                   /* 0x00000a00ff017b82 */
                                                                            /* 0x000fe40000000800 */
        /*0010*/                   F2FP.SATFINITE.E4M3.F32.PACK_AB_MERGE_C R4, R5, R6, RZ ;  /* 0x0000000605047242 */
        /*0020*/                   F2FP.F16.E4M3.UNPACK_B R7, R4 ;          /* 0x0000000405077242 */
        /*0030*/                   HADD2.F32 R8, -RZ, R7.H0_H0 ;            /* 0x20000007ff087230 */
        /*0040*/               @!P0 BRA 0x10 ;                              /* 0x0000000000008947 */
        /*0050*/                   I2F.S8 R9, R10 ;                         /* 0x0000000a00097306 */
        /*0060*/                   NOP ;                                    /* 0x0000000000007918 */
        /*0070*/                   EXIT ;                                   /* 0x000000000000794d */
		Function : _Z3foov
        /*0000*/                   EXIT ;                                   /* 0x000000000000794d */
"""


def test_parse_ptxas_and_sass():
    """Registers, stack and spills by entry function; instructions by
    function, NOPs dropped, predicates kept in the text."""
    rep = sr.parse_ptxas(PTXAS)
    assert rep[MANGLED] == {"stack": 16, "spill_stores": 12,
                            "spill_loads": 12, "registers": 128,
                            "smem": 16_384}
    assert rep["_Z3foov"]["registers"] == 32
    sass = sr.parse_sass(SASS)
    assert len(sass[MANGLED]) == 7 and sass["_Z3foov"] == ["EXIT"]
    assert sass[MANGLED][4] == "@!P0 BRA 0x10"
    assert [sr.opcode(i) for i in sass[MANGLED]][3:5] == ["HADD2.F32", "BRA"]


def test_label_and_rows():
    """The label drops namespaces and parameters; a column sweep's rows a
    loop iteration follow col_sweep_kernel's kRows."""
    name = sr.label("void (anonymous namespace)::col_sweep_kernel<(anonymous "
                    "namespace)::Fp8, signed char, true, (anonymous "
                    "namespace)::RoundCvt, (anonymous namespace)::"
                    "StoreDeltaFirst>(float*, int)")
    assert name == ("col_sweep_kernel<Fp8, signed char, true, RoundCvt, "
                    "StoreDeltaFirst>")
    assert sr.rows_per_iteration(name) == 8
    assert sr.label("(anonymous namespace)::row_sweep_kernel<float, "
                    "NanMask>(float const*)") == \
        "row_sweep_kernel<float, NanMask>"
    # cu++filt's spelling: <unnamed> namespaces, bools as (bool)1
    assert sr.label("void <unnamed>::col_sweep_kernel<<unnamed>::Fp8, "
                    "<unnamed>::NanMask, (bool)1, <unnamed>::RoundCvt, "
                    "<unnamed>::StoreOnce>(<unnamed>::Fp8 *, int)") == \
        "col_sweep_kernel<Fp8, NanMask, true, RoundCvt, StoreOnce>"
    assert sr.rows_per_iteration(
        "col_sweep_kernel<Fp8, __nv_bfloat16, true, RoundCvt, "
        "StoreOnce>") == 4
    assert sr.rows_per_iteration(
        "col_sweep_kernel<float, NanMask, true, RoundCvt, StoreOnce>") == 2
    assert sr.rows_per_iteration(
        "col_sweep_kernel<__nv_bfloat16, signed char, false, RoundCvt, "
        "StoreOnce>") == 4
    assert sr.rows_per_iteration("row_sweep_kernel<Fp8, NanMask>") is None


def test_summarize_counts_per_cell():
    """Conversions (the conversion pipe's opcodes) and f16 -> f32 moves,
    per cell of a loop iteration (8 rows x 8 cells at fp8)."""
    rec = sr.summarize(sr.parse_sass(SASS)[MANGLED], 8)
    assert rec["instructions"] == 7 and rec["branches"] == 1
    assert rec["conversion_count"] == 3 and rec["f16_to_f32_count"] == 1
    assert rec["conversions"]["I2F.S8"] == 1
    assert rec["per_cell"]["conversions"] == pytest.approx(3 / 64)
    assert rec["per_cell"]["instructions_static"] == pytest.approx(7 / 64)
    same = sr.summarize(list(sr.parse_sass(SASS)[MANGLED]), 8)
    assert same["sha256"] == rec["sha256"]
    assert sr.summarize(sr.parse_sass(SASS)[MANGLED][:-1], 8)["sha256"] \
        != rec["sha256"]
    assert "per_cell" not in sr.summarize(["EXIT"], None)


def test_line_compares_with_an_earlier_report():
    rec = {**sr.summarize(sr.parse_sass(SASS)[MANGLED], 8),
           "registers": 128, "spill_stores": 12, "spill_loads": 12}
    assert sr._line("k", rec, rec).endswith("SASS unchanged")
    other = dict(rec, sha256="0", instructions=9)
    assert "SASS differs (was 9 instructions" in sr._line("k", rec, other)
    json.dumps(rec)


def test_exits_2_without_the_toolkit(monkeypatch, capsys):
    def missing():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(build, "nvcc_path", missing)
    assert sr.main([]) == 2
    assert "nvcc not found" in capsys.readouterr().err


def test_probe_source_reports_the_streams_only():
    """``--source probe_kernels`` covers the stream kernels, not the
    gathers; the default covers the sweeps."""
    names = ["_ZN12_GLOBAL__N_121stream_rmw_vec_kernelEP13__nv_bfloat16iP5uint4xS1_i",
             "_ZN12_GLOBAL__N_118stream_read_kernelILb1ELb1EEEvPK13__nv_bfloat16PKfPfPjS6_iii",
             "_ZN12_GLOBAL__N_118stream_read_kernelILb0ELb0EEEvPK13__nv_bfloat16PKfPfPjS6_iii",
             "_ZN12_GLOBAL__N_116gather_l2_kernelILi0ELb1EEEvPKfPKiPfixiix",
             "_ZN12_GLOBAL__N_116col_sweep_kernelIfNS_7NanMaskELb1EEEvv"]
    got = [n for n in names if re.search(sr.KERNELS["probe_kernels"], n)]
    assert got == names[:3]
    assert [n for n in names if re.search(sr.KERNELS["panel_kernels"], n)] \
        == names[4:]


LOOPS = """
		Function : _Z4readv
        /*0000*/                   MOV R1, c[0x0][0x28] ;                   /* 0x00000a00ff017b82 */
        /*0010*/                   LDG.E.128.CONSTANT R4, desc[UR4][R2.64] ;  /* 0x0 */
        /*0020*/                   FADD R8, R8, R4 ;                        /* 0x0 */
        /*0030*/                   LDG.E.128.CONSTANT R12, desc[UR4][R2.64+0x10] ;  /* 0x0 */
""" + "".join(f"""        /*{0x40 + 16 * i:04x}*/                   FADD R9, R9, R5 ;                        /* 0x0 */
""" for i in range(15)) + """        /*0130*/               @P0 BRA 0x10 ;                               /* 0x0 */
        /*0140*/                   LDG.E R20, desc[UR4][R6.64] ;            /* 0x0 */
        /*0150*/                   FADD R21, R21, R20 ;                     /* 0x0 */
        /*0160*/               @P1 BRA 0x140 ;                              /* 0x0 */
        /*0170*/                   BRA 0x0 ;                                /* 0x0 */
        /*0180*/                   EXIT ;                                   /* 0x0 */
"""


def test_vector_loops_count_instructions_per_16_bytes():
    """A stream kernel's innermost loops that load 16-byte vectors: the
    loop 0x10-0x130 (2 LDG.128, 16 FADDs: 2 vectors of 8 cells, 19
    instructions) is one; the scalar loop 0x140-0x160 loads no vector, and
    the loop 0x0-0x170 holds the first, so neither counts. The addressed
    parse keeps the plain one's text."""
    addressed = sr.parse_sass(LOOPS, addresses=True)["_Z4readv"]
    assert [t for _, t in addressed] == sr.parse_sass(LOOPS)["_Z4readv"]
    assert addressed[1] == (0x10, "LDG.E.128.CONSTANT R4, desc[UR4][R2.64]")
    loops = sr.vector_loops(addressed)
    assert loops == [{"loop": [0x10, 0x130], "instructions": 19,
                      "vectors": 2.0, "per_16_bytes": 9.5}]
    rec = {**sr.summarize([t for _, t in addressed], None),
           "vector_loops": loops}
    assert "1 vector loop(s), 9.50-9.50 instructions per 16 bytes" in \
        sr._line("stream_read_kernel<true, true>", rec, None)


def test_load_loops_count_instructions_per_16_bytes_loaded():
    """A row sweep's innermost loops that load from device memory: the
    loop 0x10-0x130 (2 LDG.128, 32 bytes a lane, 19 instructions) and the
    scalar loop 0x140-0x160 (one 4-byte LDG, 3 instructions) both count;
    the loop 0x0-0x170 holds them. The line reports both."""
    addressed = sr.parse_sass(LOOPS, addresses=True)["_Z4readv"]
    loops = sr.load_loops(addressed)
    assert loops == [
        {"loop": [0x10, 0x130], "instructions": 19, "bytes": 32,
         "per_16_bytes": 9.5},
        {"loop": [0x140, 0x160], "instructions": 3, "bytes": 4,
         "per_16_bytes": 12.0}]
    assert [sr.ldg_bytes(op) for op in ("LDG.E.64", "LDG.E.U16",
                                        "LDG.E.128.CONSTANT", "LDG.E",
                                        "FADD")] == [8, 2, 16, 4, 0]
    rec = {**sr.summarize([t for _, t in addressed], None),
           "load_loops": loops, "blocks_per_sm": 3}
    line = sr._line("row_sweep_kernel<__nv_bfloat16, NanMask>", rec, None)
    assert "2 load loop(s), 9.50, 12.00 instructions per 16 bytes" in line
    assert line.endswith("; 3 blocks an SM")


def test_blocks_per_sm_from_registers_and_shared_memory():
    """The row sweep's blocks an SM: 256 threads at 80 registers (3), at
    117 (allocated as 120: 2) and at 128; shared memory limits a block of
    100 KB to 2; ptxas' smem figure is parsed."""
    assert sr.blocks_per_sm(80, 36_865, 256) == 3
    assert sr.blocks_per_sm(117, 36_865, 256) == 2
    assert sr.blocks_per_sm(128, 4_097, 256) == 2
    assert sr.blocks_per_sm(32, 100_000, 256) == 2
    assert sr.blocks_per_sm(16, 0, 256) == 8
    assert sr.parse_ptxas(PTXAS)[MANGLED]["smem"] == 16_384
