"""The column and row sweeps' (or the streams') machine code (SASS) and
ptxas' report, per instance, for one checkout of the port.

    python -m cuda_recommender_tpu_torch.scripts.sass_report [--root DIR]
        [--source panel_kernels|probe_kernels] [--out FILE]
        [--against FILE] [--dump DIR]

Compiles ``csrc/panel_kernels.cu`` (or, with ``--source probe_kernels``,
``csrc/probe_kernels.cu``, whose stream kernels it reports) of the
checkout ``--root`` (default: this one) to a cubin with
the build's flags (``ops/build.py``), reads
ptxas' registers, stack and spills of every kernel, disassembles it with
``cuobjdump -sass`` and counts, for each ``col_sweep_kernel`` and
``row_sweep_kernel`` instance: its instructions, its conversions by opcode
(F2F, F2FP, I2F, F2I and their variants: the conversion pipe's work; and
HADD2.F32, an f16 -> f32 move on the FMA pipe) and a digest of its
instruction text. A column sweep's loop body handles ``rows`` rows of 8
cells a lane, so its counts over 8·rows are per cell: for the conversions,
which lie on the loop's main path, the count each cell executes; for all
instructions, a static count that includes code only the rare branches
run. For each stream kernel it also finds the innermost loops that load
16-byte vectors (a branch back to a lower address closes a loop) and
counts each one's instructions per 16 bytes a lane loads, the vectors
being its FADDs over 8 (a vector's 8 cells each add once): the row
loops of the read's aligned path and of each of its shifted path's 8
offsets. For each row sweep instance it finds the innermost loops that
load from device memory (its item loop) and counts each one's
instructions per 16 bytes of its loads (the LDGs' widths: residual and
mask), and for the row and column sweeps the blocks an SM holds at once
by their registers and shared memory (``blocks_per_sm``: the H100's
65,536 registers and 228 KB an SM). ``--against`` compares with an
earlier ``--out`` (another
checkout's): which instances' SASS is unchanged; ``--dump`` writes each
kernel's instructions into a file of its own. Needs ``nvcc`` and
``cuobjdump`` (the CUDA toolkit): without them it exits 2.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

from ..ops import build

#: opcode prefixes that convert between number formats
CONVERSIONS = ("F2FP", "F2F", "I2FP", "I2F", "F2IP", "F2I")
#: the f16 -> f32 move (cvt.f32.f16), which runs on the FMA pipe
F16_TO_F32 = "HADD2.F32"
_CELLS_PER_LANE = 8

_FUNC = re.compile(r"Function : (\S+)")
_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.+?)\s*;")
_BRANCH = re.compile(r"\bBRA(?:\.\S+)?\s+0x([0-9a-f]+)")
_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")
#: an LDG's width in bytes by its size suffix (4 without one)
_LDG_BYTES = {".128": 16, ".64": 8, ".U16": 2, ".S16": 2, ".U8": 1,
              ".S8": 1}
#: the H100's registers and shared memory an SM (the latter less 1 KB a
#: block the system reserves: 233,472 bytes), its threads and blocks an
#: SM, and registers allocated 8 a thread at a time
SM_REGISTERS = 65_536
SM_SHARED = 233_472
BLOCK_RESERVED_SHARED = 1_024
SM_THREADS = 2_048
SM_BLOCKS = 32
#: threads a block of the kernels whose blocks an SM the report counts
BLOCK_THREADS = {"row_sweep_kernel": 256, "col_sweep_kernel": 256}
#: source -> the kernels of it that the report covers (a regex of the
#: mangled name)
KERNELS = {"panel_kernels": r"(col|row)_sweep_kernel",
           "probe_kernels": r"stream_\w+_kernel"}


def parse_ptxas(log: str) -> dict:
    """ptxas ``-v`` output -> mangled name -> {registers, stack,
    spill_stores, spill_loads}."""
    out, cur = {}, None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = _SPILL.search(line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = _REGS.search(line)
        if m:
            cur["registers"] = int(m.group(1))
        m = _SMEM.search(line)
        if m:
            cur["smem"] = int(m.group(1))
    return out


def parse_sass(text: str, addresses: bool = False) -> dict:
    """``cuobjdump -sass`` output -> mangled name -> its instructions
    (text without address and encoding; NOPs dropped), or with
    ``addresses`` (address, text) pairs."""
    out, cur = {}, None
    for line in text.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        m = _INSTR.search(line)
        if m and cur is not None and opcode(m.group(2)) != "NOP":
            cur.append((int(m.group(1), 16), m.group(2)) if addresses
                       else m.group(2))
    return out


def _innermost_loops(instrs: list, holds) -> list:
    """(first, last address, opcodes) of each innermost loop of (address,
    text) ``instrs`` that has an opcode ``holds`` accepts, a loop being
    the instructions from a branch's target up to a branch back to it."""
    loops = []
    for at, text in instrs:
        m = _BRANCH.search(text)
        if not m or int(m.group(1), 16) > at:
            continue
        start = int(m.group(1), 16)
        ops = [opcode(t) for a, t in instrs if start <= a <= at]
        if any(holds(op) for op in ops):
            loops.append((start, at, ops))
    return [(start, end, ops) for start, end, ops in loops
            if not any(start <= s2 and e2 <= end and (s2, e2) != (start, end)
                       for s2, e2, _ in loops)]


def vector_loops(instrs: list) -> list:
    """The innermost loops of (address, text) ``instrs`` that load 16-byte
    vectors (an LDG of 128 bits): each one's [first, last] address,
    instructions, vectors (its FADDs over 8: the 8 cells of a vector each
    add once) and instructions per 16 bytes."""
    out = []
    for start, end, ops in _innermost_loops(
            instrs, lambda op: op.startswith("LDG") and ".128" in op):
        vectors = sum(op.startswith("FADD") for op in ops) / 8
        out.append({"loop": [start, end], "instructions": len(ops),
                    "vectors": vectors,
                    "per_16_bytes": len(ops) / vectors if vectors else None})
    return out


def ldg_bytes(op: str) -> int:
    """The bytes a lane's LDG of opcode ``op`` loads (0 for another
    opcode)."""
    if not op.startswith("LDG"):
        return 0
    return next((n for suf, n in _LDG_BYTES.items() if suf in op), 4)


def load_loops(instrs: list) -> list:
    """The innermost loops of (address, text) ``instrs`` that load from
    device memory (an LDG): each one's [first, last] address,
    instructions, bytes a lane loads (its LDGs' widths) and instructions
    per 16 of those bytes."""
    out = []
    for start, end, ops in _innermost_loops(
            instrs, lambda op: op.startswith("LDG")):
        nbytes = sum(ldg_bytes(op) for op in ops)
        out.append({"loop": [start, end], "instructions": len(ops),
                    "bytes": nbytes,
                    "per_16_bytes": 16 * len(ops) / nbytes})
    return out


def blocks_per_sm(registers: int, smem: int, threads: int) -> int:
    """The blocks of ``threads`` threads an H100 SM holds at once with
    ``registers`` a thread (allocated 8 at a time) and ``smem`` bytes of
    shared memory a block."""
    regs = -(-registers // 8) * 8 * threads
    return min(SM_REGISTERS // regs,
               SM_SHARED // (smem + BLOCK_RESERVED_SHARED),
               SM_THREADS // threads, SM_BLOCKS)


def opcode(instr: str) -> str:
    """The opcode of an instruction, its predicate guard dropped."""
    parts = instr.split()
    if parts and parts[0].startswith("@"):
        parts = parts[1:]
    return parts[0] if parts else ""


def label(demangled: str) -> str:
    """``col_sweep_kernel<Fp8, signed char, true, RoundCvt, StoreOnce>``
    from a demangled name (namespaces, return type and parameter list
    dropped)."""
    name = re.sub(r"(\(anonymous namespace\)|<unnamed>|\w+)::", "",
                  demangled)
    name = name.replace("(bool)1", "true").replace("(bool)0", "false")
    name = name.split("(")[0].strip()
    return name[len("void "):] if name.startswith("void ") else name


def rows_per_iteration(name: str) -> int | None:
    """Rows a column-sweep instance's loop body takes (col_sweep_kernel's
    kRows: 64 residual bytes a lane, f32 2, bf16 4, fp8 8, or 4 beside a
    bf16 mask); None for another kernel."""
    m = re.match(r"col_sweep_kernel<([^,]+), ([^,]+),", name)
    if not m:
        return None
    res, mask = m.group(1).strip(), m.group(2).strip()
    if res == "float":
        return 2
    if res == "__nv_bfloat16":
        return 4
    return 4 if mask == "__nv_bfloat16" else 8


def summarize(instrs: list, rows: int | None) -> dict:
    """Instruction and conversion counts of one kernel, per cell where its
    rows per iteration are known."""
    ops = [opcode(i) for i in instrs]
    conv: dict = {}
    for op in ops:
        if op.startswith(CONVERSIONS) or op.startswith(F16_TO_F32):
            conv[op] = conv.get(op, 0) + 1
    n_conv = sum(n for op, n in conv.items() if op.startswith(CONVERSIONS))
    n_f16 = sum(n for op, n in conv.items() if op.startswith(F16_TO_F32))
    rec = {"instructions": len(ops), "conversions": conv,
           "conversion_count": n_conv, "f16_to_f32_count": n_f16,
           "branches": sum(op.startswith("BRA") for op in ops),
           "sha256": hashlib.sha256("\n".join(instrs).encode())
           .hexdigest()[:16]}
    if rows:
        cells = rows * _CELLS_PER_LANE
        rec.update(rows=rows, per_cell={
            "conversions": n_conv / cells, "f16_to_f32": n_f16 / cells,
            "instructions_static": len(ops) / cells})
    return rec


def _tool(name: str) -> str:
    """A CUDA tool beside nvcc (or on PATH); raises RuntimeError."""
    path = os.path.join(os.path.dirname(build.nvcc_path()), name)
    if os.path.exists(path):
        return path
    found = shutil.which(name)
    if found is None:
        raise RuntimeError(f"{name} not found")
    return found


def _demangle(names: list) -> dict:
    """mangled -> demangled, by cu++filt (or c++filt); names unchanged
    where neither exists."""
    for tool in ("cu++filt", "c++filt"):
        try:
            exe = _tool(tool)
        except RuntimeError:
            continue
        out = subprocess.run([exe], input="\n".join(names),
                             capture_output=True, text=True, check=True)
        return dict(zip(names, out.stdout.splitlines()))
    return {n: n for n in names}


def report(root: str, dump: str | None = None,
           source: str = "panel_kernels") -> dict:
    """label -> record (ptxas' report, ``summarize``) of every kernel of
    ``root``'s ``source``.cu that KERNELS names; with ``dump``, each one's
    SASS also into a file of that directory."""
    src = os.path.join(root, "cuda_recommender_tpu_torch", "csrc",
                       f"{source}.cu")
    flags = [f for f in build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    with tempfile.TemporaryDirectory() as tmp:
        cubin = os.path.join(tmp, f"{source}.cubin")
        done = subprocess.run([build.nvcc_path(), *flags, "-cubin", "-o",
                               cubin, src], capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{done.stderr[-4000:]}")
        ptxas = parse_ptxas(done.stdout + done.stderr)
        text = subprocess.run([_tool("cuobjdump"), "-sass", cubin],
                              capture_output=True, text=True,
                              check=True).stdout
    sass, addressed = parse_sass(text), parse_sass(text, addresses=True)
    names = _demangle(sorted(sass))
    out = {}
    for mangled, instrs in sass.items():
        if not re.search(KERNELS[source], mangled):
            continue
        name = label(names.get(mangled, mangled))
        out[name] = {**ptxas.get(mangled, {}),
                     **summarize(instrs, rows_per_iteration(name))}
        if source == "probe_kernels":
            out[name]["vector_loops"] = vector_loops(addressed[mangled])
        if name.startswith("row_sweep_kernel"):
            out[name]["load_loops"] = load_loops(addressed[mangled])
        threads = BLOCK_THREADS.get(name.split("<")[0])
        if threads and "registers" in out[name]:
            out[name]["blocks_per_sm"] = blocks_per_sm(
                out[name]["registers"], out[name].get("smem", 0), threads)
        if dump:
            os.makedirs(dump, exist_ok=True)
            fname = re.sub(r"[^A-Za-z0-9_]+", "_", name).strip("_")
            with open(os.path.join(dump, fname + ".sass"), "w") as f:
                f.write("\n".join(instrs) + "\n")
    if not out:
        raise RuntimeError(f"no {source} kernel among the {len(sass)} "
                           f"functions of {cubin}: "
                           f"{sorted(names.items())[:3]}")
    return out


def _line(name: str, rec: dict, old: dict | None) -> str:
    per = rec.get("per_cell", {})
    text = (f"{name}: {rec.get('registers')} registers, spills "
            f"{rec.get('spill_stores')}/{rec.get('spill_loads')} B, "
            f"{rec['instructions']} instructions, "
            f"{rec['conversion_count']} conversions "
            f"{dict(sorted(rec['conversions'].items()))}")
    if per:
        text += (f"; a cell: {per['conversions']:.3f} conversions, "
                 f"{per['f16_to_f32']:.3f} f16->f32, "
                 f"{per['instructions_static']:.2f} instructions (static)")
    loops = [lp["per_16_bytes"] for lp in rec.get("vector_loops", ())
             if lp["per_16_bytes"] is not None]
    if loops:
        text += (f"; {len(loops)} vector loop(s), "
                 f"{min(loops):.2f}-{max(loops):.2f} instructions per 16 "
                 f"bytes ({', '.join(f'{x:.2f}' for x in loops)})")
    loads = [lp["per_16_bytes"] for lp in rec.get("load_loops", ())]
    if loads:
        text += (f"; {len(loads)} load loop(s), "
                 f"{', '.join(f'{x:.2f}' for x in loads)} instructions per "
                 f"16 bytes loaded")
    if "blocks_per_sm" in rec:
        text += f"; {rec['blocks_per_sm']} blocks an SM"
    if old is not None:
        text += ("; SASS unchanged" if old["sha256"] == rec["sha256"] else
                 f"; SASS differs (was {old['instructions']} instructions, "
                 f"{old['conversion_count']} conversions, "
                 f"{old.get('registers')} registers, spills "
                 f"{old.get('spill_stores')} B)")
    return text


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="sass_report", description=__doc__
                                .split("\n")[0])
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    p.add_argument("--source", default="panel_kernels", choices=KERNELS,
                   help="the source whose kernels to report")
    p.add_argument("--out", help="write the records here (JSON)")
    p.add_argument("--against", help="an earlier --out to compare with")
    p.add_argument("--dump", help="write each kernel's SASS into this "
                                  "directory")
    args = p.parse_args(argv)
    try:
        recs = report(os.path.abspath(args.root), args.dump, args.source)
    except RuntimeError as err:
        print(f"sass_report: {err}", file=sys.stderr)
        return 2
    old = {}
    if args.against:
        with open(args.against) as f:
            old = json.load(f)["kernels"]
    for name, rec in sorted(recs.items()):
        print(_line(name, rec, old.get(name) if args.against else None),
              flush=True)
    out = {"root": os.path.abspath(args.root), "kernels": recs}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
