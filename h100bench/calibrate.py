"""The readings that a cell's limits are set from, on the chip at the
cell's own size, several seeds in one process:

    python3 h100bench/calibrate.py --workload hd512.train_dg \\
        --mode control --seeds 11,12,13

``--mode program``: the program's own readings (the lower end of a limit),
through the timed path on the inputs a run compares (the checked first
steps), without the window. ``--mode control``: the reference in the
program's place, computed in the precision below the configuration's
(float32 with TF32 off: TF32 on). ``--mode half_batch``: the reference in
the program's place with the second half of every batch left out (a
fault). Each seed prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from h100bench import checks, harness  # noqa: E402
from h100bench.harness import Run  # noqa: E402


def readings(cell: harness.Cell, seed: int, mode: str,
             device: torch.device) -> dict:
    run = Run(cell, seed, device, False)
    driver_mod = cell.driver()
    if mode == "program":
        driver = driver_mod.build(run)
        driver.close()
        torch.cuda.empty_cache()
        want = driver_mod.reference_run(run)
        return {**checks.training_readings(
                    driver.program, want, cell.traffic["compared_losses"]),
                "by_step": checks.loss_gaps_by_step(driver.program, want)}
    checks.tf32_off()
    want = driver_mod.reference_run(run)
    if mode == "control":
        with checks.tf32():
            prog = driver_mod.reference_run(run)
    elif mode == "half_batch":
        prog = driver_mod.reference_run(run, half_batch=True)
    else:
        raise SystemExit(f"unknown mode {mode!r}")
    return {**checks.training_readings(prog, want,
                                       cell.traffic["compared_losses"]),
            "by_step": checks.loss_gaps_by_step(prog, want)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", required=True,
                   choices=("program", "control", "half_batch"))
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.find_cell(args.workload)
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        r = readings(cell, seed, args.mode, device)
        print(json.dumps({"workload": args.workload, "mode": args.mode,
                          "seed": seed, **r,
                          "seconds": time.perf_counter() - t}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
