"""The readings that a cell's limits are set from, in one process.

    python3 -m benchmark.calibrate --workload <name> --seconds <s> \\
        --seeds 11,12,... [--control-seeds 11,12,13] [--faults 11,12,13]

For every seed: the ratings, the program's run as the benchmark runs it
(the window sized to ``--seconds``) and the plain reference; for the
``--control-seeds`` also the cell's control (``cell.control_readings``),
and for the ``--faults`` seeds each planted fault (``faults.py``) at the
sound run's iteration count. One JSON line per seed and variant:
``{"seed", "variant", "iters", "iter_s", "setup_s", "readings"}``. The
benchmark's own runs never run this.

    python3 -m benchmark.calibrate --limits FILE... [--names a,b]

prints the limits those lines give (``limits/<workload>.json``): a
reading's lower end is the largest of the sound runs; its upper end the
smallest of the control's, where that is three times the lower or more,
and of each fault's that is ten times the lower or more (a state left
unchanged: three times); the limit lies between them at two thirds of the
way up in the logarithm, rounded to two figures. A reading with no upper
end gets no limit.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _ints(text: str) -> list:
    return [int(x) for x in text.split(",") if x]


#: where between the lower and the upper end a limit lies, in the logarithm
UP = 2 / 3


def limits(lines: list, names=None) -> dict:
    """The limits of the calibration ``lines`` of one workload."""
    import math

    out, notes = {}, {}
    keys = sorted({k for r in lines for k in r["readings"]})
    for key in keys if names is None else names:
        sound = [(r["readings"][key], r["seed"]) for r in lines
                 if r["variant"] == "program" and key in r["readings"]]
        if not sound:
            continue
        lower, at = max(sound)
        ups, controls = [], []
        for var in sorted({r["variant"] for r in lines} - {"program"}):
            vals = [(r["readings"][key], r["seed"]) for r in lines
                    if r["variant"] == var and key in r["readings"]]
            if not vals:
                continue
            least = min(vals)
            if var == "control":
                controls.append(least[0])
            if least[0] >= (3 if var in ("control", "unchanged") else 10) \
                    * lower:
                ups.append((least[0], var, least[1]))
        if not ups:
            notes[key] = {"lower": lower, "seeds": len(sound),
                          "control_min": controls[0] if controls else None}
            continue
        upper, var, seed = min(ups)
        lim = math.exp((1 - UP) * math.log(lower) + UP * math.log(upper))
        out[key] = {"limit": float(f"{lim:.2g}"), "lower": lower,
                    "lower_seed": at, "upper": upper, "upper_from": var,
                    "upper_seed": seed, "sound_seeds": len(sound)}
    return {"limits": out, "not_compared": notes}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.calibrate")
    p.add_argument("--limits", nargs="+", metavar="FILE",
                   help="print the limits of these calibration lines")
    p.add_argument("--names", type=lambda t: t.split(","), default=None)
    p.add_argument("--workload")
    p.add_argument("--seconds", type=float)
    p.add_argument("--seeds", type=_ints)
    p.add_argument("--control-seeds", type=_ints, default=[])
    p.add_argument("--faults", type=_ints, default=[],
                   help="seeds at which every fault is planted")
    args = p.parse_args(argv)
    if args.limits:
        lines = [json.loads(line) for f in args.limits for line in open(f)
                 if line.startswith("{")]
        print(json.dumps(limits(lines, args.names), indent=1))
        return 0
    import torch

    from . import cell as cellmod, datagen, faults, spec

    c = spec.resolve(spec.load_spec(), args.workload)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    trajectory = cellmod.check_mode(c) == "trajectory"
    for seed in args.seeds:
        t0 = time.perf_counter()
        data = datagen.generate(c.traffic, seed, device)
        cellmod._free(device)
        out = cellmod.run_program(c, data, seed, args.seconds, device)
        ref = cellmod.reference_run(c, data, seed, out, device)
        rows = [("program", out.window_s / out.iters,
                 cellmod.readings_of(c, out, ref, data, device))]
        if seed in args.control_seeds:
            rows.append(("control", None, cellmod.control_readings(
                c, data, seed, out, ref, device)))
        if seed in args.faults:
            for fault in faults.FAULTS:
                f = cellmod.run_program(c, data, seed, 0.0, device,
                                        iters=out.iters, fault=fault)
                fref = (ref if trajectory else
                        cellmod.reference_run(c, data, seed, f, device))
                rows.append((fault, None,
                             cellmod.readings_of(c, f, fref, data, device)))
                del f, fref
                cellmod._free(device)
        for variant, iter_s, readings in rows:
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "variant": variant, "iters": out.iters,
                              "iter_s": iter_s, "setup_s": out.setup_s,
                              "readings": readings}), flush=True)
        print(f"[calibrate] seed {seed}: {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)
        del data, ref, out
        cellmod._free(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
