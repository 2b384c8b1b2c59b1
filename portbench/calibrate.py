"""Readings that a cell's limits are set from, on the card, in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 12 \
        [--control-seeds 3] [--out chiprun_out/calibrate_<cell>.json]

Each reading is one run of the cell through ``run.run``, as the driver
runs it, with a short window: the sound runs on ``--seeds`` seeds; then the
control, the port's own bfloat16 path (``compute_dtype``), and each fault
of ``portbench/faults.py`` that the cell's traffic can have, on
``--control-seeds`` seeds each. Each reading keeps the run's ``correct``,
its compared numbers beside their limits, and every other number the check
can compare. The benchmark's own runs never run this.
"""

import argparse
import contextlib
import io
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def reading(workload, seed, device, compute_dtype="float32", fault=None,
            cell_files=None, seconds=2.0):
    """The result line of one run of ``workload`` under ``fault`` (a name
    in ``faults.FAULTS``), with its "readings"."""
    import torch
    from portbench import faults, run
    files = cell_files or run.load_cell(workload)
    args = run.parse(["--workload", workload, "--seed", str(seed),
                      "--seconds", str(seconds), "--trace", "0"])
    broken = (faults.FAULTS[files[2]["kind"]][fault]() if fault
              else contextlib.nullcontext())
    out = io.StringIO()
    with broken, contextlib.redirect_stdout(out):
        rc = run.run(args, device, files, compute_dtype, readings=True)
    if rc != 0:
        raise RuntimeError(f"{workload} seed {seed}: exit {rc}")
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return json.loads(out.getvalue().strip().splitlines()[-1])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_017)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--skip-faults", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    from portbench import faults, run
    run.cache_env()
    import torch
    if not torch.cuda.is_available():
        print("calibrate.py needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    kind = run.load_cell(args.workload)[2]["kind"]
    seeds = [args.first_seed + 7919 * k for k in range(args.seeds)]
    plan = [(s, "float32", None) for s in seeds]
    plan += [(s, "bfloat16", None) for s in seeds[:args.control_seeds]]
    if not args.skip_faults:
        plan += [(s, "float32", f) for f in faults.FAULTS[kind]
                 for s in seeds[:args.control_seeds]]
    rows = []
    for seed, dtype, fault in plan:
        t0 = time.perf_counter()
        line = reading(args.workload, seed, device, dtype, fault,
                       seconds=args.seconds)
        row = {"seed": seed, "dtype": dtype, "fault": fault,
               "correct": line["correct"], "readings": line["readings"],
               "checks": line["checks"],
               "seconds": time.perf_counter() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)
    out = Path(args.out or ROOT / "chiprun_out" /
               f"calibrate_{args.workload}.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rows, indent=1))
    for kind in sorted({(r["dtype"], r["fault"]) for r in rows}, key=str):
        sel = [r for r in rows if (r["dtype"], r["fault"]) == kind]
        span = {k: (min(r["readings"][k] for r in sel),
                    max(r["readings"][k] for r in sel))
                for k in sel[0]["readings"]}
        print(f"{kind}: {sum(r['correct'] for r in sel)} of {len(sel)} "
              f"correct; min/max {span}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
