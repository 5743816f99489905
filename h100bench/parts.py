"""One cell's traced window by the program's parts, for reading where a
step's time goes: device ms, idle ms, launches and synchronising calls a
call or step for each ``havatar.*`` span (``trace_parts.py``), for
``unnamed`` (in a step call, under no span) and ``total`` (all of the step
calls), with the share of device time linked to its launch call, the
traced and the untraced ms a call or step, and the cell's per-layer
metrics as ``run.py --trace 1`` reads them. ``part_ranges_as_kernels``
names any program range that ``trace.reduce`` took for device work (it
should be empty: the profiler marks a range's device-side copy as a user
annotation).

    python3 h100bench/parts.py --workload hd512.train_dg --seed 7 \\
        --seconds 30

Set-up and window as ``run.py``'s (the profiler over the window's first
calls or steps, whose end, the profiler's own processing, falls in the
window), then a second window of ``--seconds`` with no profiler for the
untraced ms; no check against the reference. One JSON line on standard
output; CUDA only.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from h100bench import run as bench  # noqa: E402  (sets the cache paths)
from h100bench import harness  # noqa: E402
from h100bench.harness import Run  # noqa: E402
from h100bench.trace import Tracer  # noqa: E402
from h100bench.trace_parts import PART, reduce_parts  # noqa: E402

import torch  # noqa: E402


def parts_table(parts) -> dict:
    """{part: {device_ms, idle_ms, launches, syncs} a call or step}."""
    u = parts.units
    return {name: {"device_ms": p["device_s"] / u * 1e3,
                   "idle_ms": p["idle_s"] / u * 1e3,
                   "launches": p["launches"] / u,
                   "syncs": p["syncs"] / u}
            for name, p in sorted(parts.parts.items())}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("h100bench: parts.py needs a CUDA device", file=sys.stderr)
        return 2
    cell = harness.find_cell(args.workload)
    torch.set_num_threads(2)
    device = torch.device("cuda", 0)
    run = Run(cell, args.seed, device, True)
    driver = cell.driver().build(run)
    torch.cuda.synchronize(device)
    run.setup_s = time.perf_counter() - T_START
    tracer = Tracer(device)
    driver.window(args.seconds, tracer)
    run.traced = t = tracer.result()
    parts = reduce_parts(tracer._prof, t.units)
    metrics = {m["name"]: harness.reader(m["name"])(run)
               for m in cell.per_layer}
    run.trace = False
    driver.window(args.seconds)
    driver.close()
    out = {"workload": cell.name, "seed": args.seed, "card": bench.card(),
           "setup_s": run.setup_s, "units_traced": t.units,
           "traced_ms": t.window_s / t.units * 1e3,
           "busy_ms": t.busy_s / t.units * 1e3,
           "untraced_ms": run.window_s / run.units * 1e3,
           "linked_share": parts.linked_share,
           "parts": parts_table(parts), "metrics": metrics,
           "part_ranges_as_kernels": sorted(
               k for k in t.kernels if k.startswith(PART))}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
