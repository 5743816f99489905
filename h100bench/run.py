"""One run of one benchmark cell of havatar_tpu_torch on the CUDA device(s)
of this machine.

    python3 h100bench/run.py --workload hd512.train_dg --seed 7 \\
        --seconds 51 --trace 0

Set-up (timed as ``setup_s``, from the start of this process): imports,
the program's models with weights drawn on the device from the seed, the
kernels' build (into the checkout's ``build/``, reused by later runs) and a
warm-up of the cell's own shapes. Then the window: ``--seconds`` of the
cell's traffic. With ``--trace 1`` the cell's per-layer metrics are read
instead of its end-to-end ones: spans from CUDA events, and
``torch.profiler`` over the first calls or steps of the window. After the
window the program's state is freed and its outputs are held against the
plain reference (``reference/``); each number compared is printed beside
its limit (``limits/<cell>.json``) on standard error and as the result
line's last key.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and ``breakdown`` when
traced). The run exits non-zero with no result when CUDA is missing, when a
JAX module was loaded, or outside a checkout that holds the program.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# kernel caches at fixed paths inside the checkout; no library loads JAX
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(ROOT / "build" / "torch_extensions"))
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from h100bench import harness  # noqa: E402
from h100bench.harness import Run  # noqa: E402
from h100bench.trace import Tracer  # noqa: E402


def card() -> dict:
    """The card's name and power limit (``nvidia-smi``), printed beside
    every share of a peak."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()[0]
        name, limit = (s.strip() for s in out.split(","))
        return {"name": name, "power_limit": limit}
    except (OSError, IndexError, ValueError, subprocess.SubprocessError):
        return {"name": torch.cuda.get_device_name(0),
                "power_limit": "unknown"}


def measure(cell: harness.Cell, seed: int, seconds: float, trace: bool,
            device: torch.device, t_start: float) -> tuple:
    """Set-up, window and check of one run -> (Run, readings)."""
    run = Run(cell, seed, device, trace)
    harness.log("imports done")
    driver = cell.driver().build(run)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    run.setup_s = time.perf_counter() - t_start
    harness.log(f"set-up done: {run.setup_s:.2f} s")
    tracer = Tracer(device) if trace else None
    driver.window(seconds, tracer)
    if tracer is not None:
        run.traced = tracer.result()
    if device.type == "cuda":
        run.extra["memory_peak_bytes"] = torch.cuda.max_memory_allocated(
            device)
    driver.close()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    harness.log(f"window done: {run.units} calls or steps")
    readings = driver.check()
    harness.log("check done")
    return run, readings


def result(run: Run, readings: dict, chips: int) -> dict:
    """The result line (without the device's name, added by ``main``)."""
    cell = run.cell
    wanted = cell.per_layer if run.trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = harness.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    check = {k: {"value": readings.get(k), "limit": limit}
             for k, limit in cell.limits.items()}
    correct = bool(check) and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in check.values())
    out = {"correct": correct, "attempted": run.units,
           "failed": 0, "metrics": metrics,
           "device": {"platform": "gpu", "count": chips,
                      "memory_peak_bytes": run.extra.get(
                          "memory_peak_bytes", 0)}}
    if run.trace and run.traced is not None:
        out["device"]["busy_s"] = run.traced.busy_s
        out["device"]["window_s"] = run.traced.window_s
        out["breakdown"] = run.traced.breakdown()
    out["check"] = check
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    cell = harness.find_cell(args.workload)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"h100bench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); found {found}", file=sys.stderr)
        return 2
    try:
        import havatar_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"h100bench: the program is not in this checkout: {e}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    device = torch.device("cuda", 0)
    run, readings = measure(cell, args.seed, args.seconds,
                            bool(args.trace), device, T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"h100bench: modules that no run may load: {bad}",
              file=sys.stderr)
        return 3
    out = result(run, readings, cell.chips)
    out["device"]["kind"] = torch.cuda.get_device_name(0)
    if args.trace:
        out["card"] = card()
        out["check"] = out.pop("check")
    for k, c in out["check"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
