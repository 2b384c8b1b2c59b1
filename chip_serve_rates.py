"""The congeal rates of chip_smoke.py's serve phase, with the harness and the
package each taken from a tree of the repo, and the time the garbage
collector takes inside the timed parts.

    python3 chip_serve_rates.py [--harness DIR] [--package DIR]

DIR is the root of a checkout (default: this script's). The script loads
DIR/chip_smoke.py as the harness and imports gangealing_torch from the
package's DIR, then runs the harness's setup, kernels_vs_plain and serve
as chip_smoke.main does, in this order. So a parent unpacked with
`git archive` into an ignored directory (build/parent) can be run with
either tree's harness or package, in turns within one call. Each timed part
of serve is timed again on the host clock, and every collection the
garbage collector makes in it is counted with its seconds. Needs one CUDA
card; the last line is a JSON object with the rates.
"""

import argparse
import gc
import importlib.util
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def load_harness(harness, package):
    """chip_smoke.py of ``harness``, with gangealing_torch from
    ``package``."""
    sys.path.insert(0, package)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(harness, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    import gangealing_torch
    got = os.path.dirname(os.path.dirname(os.path.abspath(
        gangealing_torch.__file__)))
    if got != os.path.abspath(package):
        raise RuntimeError(f"gangealing_torch came from {got}, not {package}")
    return cs


class GcClock:
    """The garbage collector's collections and their seconds, by
    generation, while ``on``."""

    def __init__(self):
        self.on = False
        self.count = [0, 0, 0]
        self.seconds = [0.0, 0.0, 0.0]
        self._t0 = None
        gc.callbacks.append(self)

    def __call__(self, phase, info):
        if not self.on:
            return
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            g = info["generation"]
            self.count[g] += 1
            self.seconds[g] += time.perf_counter() - self._t0
            self._t0 = None


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--harness", default=ROOT)
    ap.add_argument("--package", default=ROOT)
    args = ap.parse_args()
    cs = load_harness(os.path.abspath(args.harness),
                      os.path.abspath(args.package))
    clock = GcClock()
    parts = []  # (host seconds, gc collections, gc seconds) a timed call
    timed_parts = cs.timed_parts

    def clocked_parts(run_part, check_result):
        c0, s0 = list(clock.count), list(clock.seconds)
        clock.on = True
        t0 = time.perf_counter()
        ms = timed_parts(run_part, check_result)
        seconds = time.perf_counter() - t0
        clock.on = False
        parts.append((seconds, [a - b for a, b in zip(clock.count, c0)],
                      sum(clock.seconds) - sum(s0)))
        return ms

    cs.timed_parts = clocked_parts
    dev, card = cs.setup()
    cs.kernels_vs_plain(dev)
    rates, *_ = cs.serve(dev, card)
    out = {"harness": os.path.abspath(args.harness),
           "package": os.path.abspath(args.package),
           "gc_objects": len(gc.get_objects()),
           "modules": len(sys.modules)}
    for b, (seconds, collections, gc_s) in zip(cs.BATCHES, parts):
        rate, sub, _ = rates[b]
        print(f"congeal batch {b}: {rate:.1f} imgs/s (parts "
              f"{', '.join(f'{r:.1f}' for r in sub)}); host clock "
              f"{seconds:.3f} s, garbage collections {collections} (by "
              f"generation) taking {gc_s * 1e3:.1f} ms [{card}]")
        out[f"congeal_{b}"] = rate
        out[f"gc_ms_{b}"] = gc_s * 1e3
        out[f"gc_collections_{b}"] = collections
    print(card)
    print(json.dumps(out))


if __name__ == "__main__":
    sys.exit(main())
