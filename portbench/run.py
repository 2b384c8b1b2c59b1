"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is found by name in ``BENCHMARK.json``; its configuration, its
traffic mix, its limits and its metrics' readers are files found by name
under ``portbench/``. Set-up builds the program's state from the seed and
warms every shape the traffic uses. With ``--trace 0`` the window runs the
traffic's units for ``--seconds`` and the cell's end-to-end metrics are
read from it; with ``--trace 1`` a profiled window of the traffic's
``trace_units`` units gives its per-layer metrics. Then the program's
state is freed and the plain reference decides ``correct``.
"""

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "portbench"
# what the process that prints the result may not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "gangealing_tpu")


def cache_env():
    """Every build and kernel cache at a fixed path inside the checkout,
    Python's bytecode of torch and of the port among them: without it each
    run compiles some 1,900 modules from source again."""
    cache = ROOT / "build" / "portbench_cache"
    sys.pycache_prefix = str(cache / "pycache")
    sys.dont_write_bytecode = False
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    os.environ["USE_FLAX"] = "0"


def read_json(path):
    with open(path) as f:
        return json.load(f)


def load_cell(workload, bench_path=ROOT / "BENCHMARK.json"):
    """The cell's entry, configuration, traffic, limits, and the names of
    its end-to-end and per-layer metrics, from ``BENCHMARK.json`` and the
    files its names lead to."""
    bench = read_json(bench_path)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in {bench_path}; "
                         f"there are {sorted(cells)}")
    cell = cells[workload]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = read_json(ROOT / config["file"])
    traffic = read_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    limits = read_json(BENCH / "limits" / f"{workload}.json")
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if workload in m["workloads"] or
             ("workloads" not in m and m["moves"] in reported)]
    return cell, cfg, traffic, limits, e2e, layer


def reader(name):
    """The ``read`` function of ``portbench/metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def driver(kind):
    """The module of ``portbench/drivers/<kind>.py``."""
    return importlib.import_module(f"portbench.drivers.{kind}")


class Window:
    """What the measured window saw: each unit's host-clock start and end
    and its images, the window's length, and set-up's seconds."""

    def __init__(self, setup_s, unit_images):
        self.setup_s = setup_s
        self.unit_images = unit_images
        self.starts, self.ends = [], []
        self.seconds = 0.0

    @property
    def units(self):
        return len(self.ends)


def sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_window(cell, seconds, setup_s, device):
    """Units back to back until ``seconds`` have passed; the window closes
    at the synchronize after the unit that crossed them."""
    w = Window(setup_s, cell.unit_images)
    t0 = time.perf_counter()
    while True:
        w.starts.append(time.perf_counter())
        cell.run_unit()
        w.ends.append(time.perf_counter())
        if w.ends[-1] - t0 >= seconds:
            break
    sync(device)
    w.ends[-1] = time.perf_counter()
    w.seconds = w.ends[-1] - t0
    return w


def check_lines(numbers, limits):
    """(correct, ordered {name: {"value", "limit"}}) of the numbers
    compared; a number that is not finite or over its limit fails."""
    out, correct = {}, True
    for name, limit in limits.items():
        value = numbers.get(name, math.inf)
        ok = math.isfinite(value) and value <= limit
        correct &= ok
        out[name] = {"value": value, "limit": limit}
    return correct, out


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    cache_env()
    sys.path.insert(0, str(ROOT))
    cell_entry, _, _, _, _, _ = load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell_entry["chips"]:
        print(f"portbench: {args.workload} needs {cell_entry['chips']} CUDA "
              f"device(s); {torch.cuda.device_count()} visible",
              file=sys.stderr)
        return 2
    return run(args, torch.device("cuda", 0))


def run(args, device, cell_files=None, compute_dtype="float32",
        readings=False):
    """The run of ``args`` on ``device``; prints the result line and
    returns the exit code. ``cell_files``: ``load_cell``'s tuple, in place
    of the files the workload's name leads to. ``compute_dtype``: the
    port's own lower-precision path in place of the configuration's, the
    control. ``readings``: the line also carries, under "readings", every
    number the check can compare, for ``portbench/calibrate.py``."""
    import torch
    cell_entry, cfg, traffic, limits, e2e, layer = (
        cell_files or load_cell(args.workload))
    parts = {"imports": time.perf_counter() - PROCESS_START}
    t0 = time.perf_counter()
    torch.zeros(1, device=device)
    sync(device)
    parts["device context"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    kind = driver(traffic["kind"])
    parts["the port's imports"] = time.perf_counter() - t0
    cell = kind.build(cfg, traffic, args.seed, device, parts, compute_dtype)
    sync(device)
    setup_s = time.perf_counter() - PROCESS_START
    for part, s in parts.items():
        print(f"set-up: {part} {s:.3f} s", file=sys.stderr)
    print(f"set-up: total {setup_s:.3f} s", file=sys.stderr)
    if args.trace:
        from portbench.trace import Trace, profiled
        n = traffic["trace_units"]
        events, span, taken = profiled(
            lambda: [cell.run_unit() for _ in range(n)])
        print(f"trace: {n} units, {taken} window(s) taken", file=sys.stderr)
    else:
        window = run_window(cell, args.seconds, setup_s, device)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    cell.release()
    numbers, notes, counters = cell.check(list(limits),
                                          count=bool(args.trace),
                                          readings=readings)
    if args.trace:
        observed = Trace(events, span, n, counters)
        del events
    else:
        observed = window
    metrics = {}
    for m in (layer if args.trace else e2e):
        value = reader(m["name"])(observed)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    found = forbidden_modules()
    if found:
        print(f"portbench: the process holds {found}", file=sys.stderr)
        return 3
    correct, checks = check_lines(numbers, limits)
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
                   "count": cell_entry["chips"], "memory_peak_bytes": peak}
    result = {"correct": correct,
              "attempted": observed.units, "failed": 0 if correct else 1,
              "metrics": metrics, "device": device_info}
    if args.trace:
        device_info.update(busy_s=observed.busy_s,
                           window_s=observed.window_s)
        result["breakdown"] = observed.breakdown()
    if readings:
        result["readings"] = numbers
    result["checks"] = checks
    for key, value in notes.items():
        print(f"check: {key}: {value}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
