"""The gates of chip_smoke.py's card-against-CPU congeal of a trained
synthetic STN (chip_smoke.py::synthetic_card_vs_cpu), from CPU readings
alone.

It trains the synthetic demo (gangealing_torch/train/synthetic.py) at its
published settings on the CPU, as the smoke trains it on the card, then
congeals the demo's eval images with the trained STN on the CPU path three
ways: in float32, with the STN's weights and activations in float64 (the
samplers compute in float32 whatever their input) and with oneDNN off
(native convolutions). It prints how far the congealed images and their
grids part between these, and the gates: GATE_FACTOR times the largest
reading, rounded up to one significant figure.

    python3 chip_synthetic_gate.py [--iters 150] [--heads 1] [--threads 4]
"""

import argparse
import copy
import math
import time

import torch

from gangealing_torch.train.synthetic import (
    eval_images, make_template, post_anneal_descent, run_synthetic_congealing)

GATE_FACTOR = 10


def congealed(t, imgs):
    """The congealed images and their sampling grids."""
    with torch.no_grad():
        out, grid = t(imgs, padding_mode="border")[:2]
    return out.double(), grid.double()


def round_up(x):
    """``x`` rounded up to one significant figure."""
    e = math.floor(math.log10(x))
    return math.ceil(x / 10 ** e) * 10 ** e


def readings(t, imgs):
    """{what: (image max abs, grid max abs)} of each variant of the CPU
    path against its float32 run."""
    ref = congealed(t, imgs)
    t64 = copy.deepcopy(t).double()
    runs = {"float64": congealed(t64, imgs.double())}
    torch.backends.mkldnn.enabled = False
    runs["oneDNN off"] = congealed(t, imgs)
    torch.backends.mkldnn.enabled = True
    return {k: tuple(float((a - b).abs().max()) for a, b in zip(v, ref))
            for k, v in runs.items()}


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--iters", type=int, default=150)
    p.add_argument("--heads", type=int, default=1)
    p.add_argument("--threads", type=int, default=4)
    args = p.parse_args()
    torch.set_num_threads(args.threads)
    t0 = time.perf_counter()
    r = run_synthetic_congealing(iters=args.iters, size=64, batch=16,
                                 num_heads=args.heads, device="cpu")
    early, late = post_anneal_descent(r.losses, max(1, int(args.iters * 0.3)))
    print(f"trained {args.iters} iterations at K={args.heads} on the CPU in "
          f"{time.perf_counter() - t0:.1f} s: post-annealing loss {early:.5f} "
          f"-> {late:.5f} ({late / early:.3f}x), congealed variance "
          f"{r.var_before:.5f} -> {r.var_after:.5f} "
          f"({r.var_after / r.var_before:.3f}x)")
    templates = [make_template(64, m) for m in range(args.heads)]
    imgs = eval_images(templates, 32, 64, 0, "cpu")
    read = readings(r.state.t, imgs)
    for k, (img, grid) in read.items():
        print(f"CPU path, {k} against float32: congealed images {img:.3e}, "
              f"grids {grid:.3e}")
    worst = [max(v[i] for v in read.values()) for i in range(2)]
    print(f"gates ({GATE_FACTOR}x the largest, rounded up): congealed "
          f"images {round_up(GATE_FACTOR * worst[0]):.0e}, grids "
          f"{round_up(GATE_FACTOR * worst[1]):.0e}")


if __name__ == "__main__":
    main()
