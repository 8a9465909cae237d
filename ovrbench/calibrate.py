"""Readings that the comparison's limits are set from, in one process.

    python3 -m ovrbench.calibrate --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 [--seconds 2]

For each seed a short run of the cell as the benchmark runs it (the same
window, frames held and comparison, at the cell's own size): the sound
program's `rgba_err` and `checked_px`, and with `--control-seeds` the
control's: the program with its own lower-precision path switched on
(`sw_bf16`: the slice loop's and the warp's resampling operands rounded
to bfloat16), which has to come out not correct. Prints one JSON line per
run and a summary: the largest sound reading (the lower one) and the
smallest control reading (the upper one). The benchmark's own runs never
run the control.
"""

from __future__ import annotations

import argparse
import json
import sys

from ovrbench import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        run.log("calibration runs on the card")
        return 3
    cell = run.Cell(run.ROOT, args.workload)
    out = {"sound": [], "control": []}
    for kind, seeds, opts in (("sound", args.seeds, None),
                              ("control", args.control_seeds,
                               {"sw_bf16": True})):
        for s in filter(None, seeds.split(",")):
            res, lines = run.run_cell(cell, int(s), args.seconds, False,
                                      "cuda", render_options=opts)
            errs = lines[-1].split(": ", 1)[1]
            row = {"kind": kind, "seed": int(s), "correct": res["correct"],
                   "rgba_err": res["compared"]["rgba_err"]["value"],
                   "checked_px": res["compared"]["checked_px"]["value"],
                   "frames": res["attempted"], "held_errs": errs}
            out[kind].append(row)
            print(json.dumps(row), flush=True)
    summary = {"workload": cell.name}
    if out["sound"]:
        summary["lower"] = max(r["rgba_err"] for r in out["sound"])
        summary["fewest_px"] = min(r["checked_px"] for r in out["sound"])
    if out["control"]:
        summary["upper"] = min(r["rgba_err"] for r in out["control"])
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
