"""The batch of the LSUN-cars run on one card: the peak memory and the time
of its step at batches 5 to 40 (the recipe's global batch), and the
largest whose step peaks under 90% of the card's memory.

    python3 chip_cars_batch.py [--compute_dtype bfloat16]

Each batch runs python -m gangealing_torch.cli.train in process on
chip_smoke.py's cars flags (scripts/training/lsun_cars.sh, seeded random G
and LPIPS, --debug) for one iteration, then 2 train steps, each with the
peak memory reset before it, in ``--compute_dtype`` (float32 by
default; bfloat16 runs both G passes and the LPIPS trunk in bfloat16). A
batch that runs out of memory is reported so, and the larger ones are not
tried. Needs one CUDA card; the last line
is a JSON object with the chosen batch.
"""

import argparse
import gc
import json
import os
import sys
import tempfile
import time

import torch

import chip_smoke as cs

BATCHES = (5, 10, 15, 20, 25, 30, 35, 40)
STEPS = 2
SHARE = 0.9


def measure(dev, batch, compute_dtype):
    """(seconds of the last step, its peak GiB) at ``batch``."""
    d = tempfile.mkdtemp()
    gpath = os.path.join(d, "g.pt")
    torch.save({"g_ema": cs.Generator(
        cs.GeneratorConfig(),
        generator=torch.Generator().manual_seed(3)).state_dict()}, gpath)
    state, generator, _, pfn = cs.train_cli.main(cs.cars_argv(
        os.path.join(d, "results"), gpath, batch, 1, "--load_G_only",
        "--compute_dtype", compute_dtype))
    rng = torch.Generator(dev).manual_seed(5)
    for _ in range(STEPS):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        z = torch.randn(batch, state.cfg.g.style_dim, generator=rng,
                        device=dev)
        cs.train_step(state, generator, pfn, z, 0.5, 1e-3, 1e-2, rng=rng)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    return seconds, torch.cuda.max_memory_allocated(dev) / 2 ** 30


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--compute_dtype", default="float32",
                        choices=["float32", "bfloat16"])
    compute_dtype = parser.parse_args().compute_dtype
    dev, card = cs.setup()
    total = torch.cuda.get_device_properties(dev).total_memory / 2 ** 30
    chosen = None
    for batch in BATCHES:
        try:
            seconds, peak = measure(dev, batch, compute_dtype)
        except torch.OutOfMemoryError as e:
            print(f"{compute_dtype} cars step, batch {batch}: out of memory "
                  f"({str(e).splitlines()[0][:100]}) [{card}]")
            break
        finally:
            gc.collect()
            torch.cuda.empty_cache()
        fits = peak < SHARE * total
        print(f"{compute_dtype} cars step, batch {batch}: {seconds:.3f} s, "
              f"{batch / seconds:.2f} imgs/s, peak {peak:.2f} GiB of "
              f"{total:.2f} ({peak / total:.1%}) [{card}]")
        if not fits:
            break
        chosen = batch
    print(card)
    print(json.dumps({"cars_batch": chosen, "share": SHARE,
                      "card_gib": total, "compute_dtype": compute_dtype}))


if __name__ == "__main__":
    sys.exit(main())
