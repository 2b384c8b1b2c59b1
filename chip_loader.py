"""The native image loader on one CUDA card's host: its decode rates against
the PIL loader's, and the flagship congeal forward fed by each.

    python3 chip_loader.py [--images 512] [--batches 30]

Builds ``--images`` smooth 256 px images (chip_smoke.py's generator,
seed 31) into an LMDB of PNGs and one of JPEGs (quality 95), as
prepare_data writes them, then:
  1. decode rates: batches of 50 (the eval CLIs' default) from
     ``data/dataset.py::img_dataloader`` (PIL, one image at a time in this
     thread) and from ``data/native_loader.NativeImageLoader`` at 1, 2, 4,
     8 and 16 threads (prefetch depth 4), each timed by the host clock from
     the loader's construction to its ``--batches``-th batch, over the
     epochs that takes; the first batch of each native run held against
     the PIL path (1e-5); and the host's time for one batch's
     ``NativeImageLoader.next`` with the batch already decoded (its two
     copies) and for its ``torch.from_numpy(b).to(device)`` (a pageable
     copy to the card), each the median of 5;
  2. fed forwards: the flagship ComposedSTN congeal forward at batch 50
     (chip_smoke.congeal: the forward and its flow scores, brought to the
     host each batch as the flow-scores app does) fed by the PIL loader,
     by the native loader at 4 and at 8 threads, and by batches decoded
     beforehand and held in memory (no decode: the loop's floor), each
     batch moved to the card with ``torch.from_numpy(b).to(device)`` as
     the apps move it: imgs/s over ``--batches`` batches after 2 warm-up
     batches, and the device's busy time and idle share over 8 batches
     under ``utils/profiling.trace`` (a Chrome trace, read by
     chip_smoke.trace_busy), with the time the consumer waited on each
     source for its batches.
Needs one CUDA card; prints the card's name and power limit, and a JSON
object of the figures as its last line.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

import chip_smoke as cs
from gangealing_torch.data import native_loader
from gangealing_torch.data.dataset import (
    MultiResolutionDataset, img_dataloader)
from gangealing_torch.utils.profiling import trace

BATCH = 50
THREADS = (1, 2, 4, 8, 16)
DEPTH = 4
FED_THREADS = (4, 8)
WARM = 2
TRACED = 8


def pil_batches(path):
    return img_dataloader(path, resolution=256, batch_size=BATCH,
                          shuffle=False, drop_last=False)


def native_batches(path, threads):
    ldr = native_loader.NativeImageLoader(
        path, resolution=256, batch=BATCH, num_threads=threads,
        shuffle=False, prefetch_depth=DEPTH)
    try:
        while True:
            yield ldr.next()[0]
    finally:
        ldr.close()


def held_batches(batches):
    """The batches, cycled from memory."""
    while True:
        yield from batches


def decode_rate(make, n):
    """Images a second of the first ``n`` batches of ``make()``, timed
    from the call, and the first batch."""
    t0 = time.perf_counter()
    it = make()
    first = next(it)
    count = len(first)
    for _ in range(n - 1):
        count += len(next(it))
    seconds = time.perf_counter() - t0
    it.close()
    return count / seconds, first


def copy_ms(path, dev):
    """The median ms of ``next()`` on a batch that is already decoded,
    and of moving a batch to the card."""
    ldr = native_loader.NativeImageLoader(
        path, resolution=256, batch=BATCH, num_threads=8, shuffle=False,
        prefetch_depth=DEPTH)
    nexts, moves = [], []
    for _ in range(5):
        time.sleep(0.5)  # the workers decode the next batch meanwhile
        t0 = time.perf_counter()
        b, _ = ldr.next()
        nexts.append(1e3 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.from_numpy(b).to(dev)
        torch.cuda.synchronize()
        moves.append(1e3 * (time.perf_counter() - t0))
    ldr.close()
    return float(np.median(nexts)), float(np.median(moves))


def fed(model, dev, batches, n):
    """The congeal forward over ``n`` batches of ``batches``: seconds, the
    seconds spent waiting on the source, and the images."""
    waited = count = 0
    t0 = time.perf_counter()
    for _ in range(n):
        w0 = time.perf_counter()
        b = next(batches)
        waited += time.perf_counter() - w0
        result = cs.congeal(model, torch.from_numpy(b).to(dev))
        result[3].cpu().numpy()  # the scores to the host, as the apps do
        count += len(b)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, waited, count


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--images", type=int, default=512)
    parser.add_argument("--batches", type=int, default=30)
    args = parser.parse_args()
    dev, card = cs.setup()
    print(f"host: {os.cpu_count()} CPUs; the loader linked "
          f"{native_loader.linked_libraries()}")
    d = tempfile.mkdtemp()
    imgs = cs.smooth_images(args.images,
                            torch.Generator().manual_seed(31)).numpy()
    t0 = time.perf_counter()
    paths = {"PNG": cs.image_lmdb(os.path.join(d, "png"), imgs),
             "JPEG": cs.image_lmdb(os.path.join(d, "jpeg"), imgs,
                                   cs.jpeg_bytes)}
    sizes = {k: os.path.getsize(os.path.join(p, "data.mdb")) / 2 ** 20
             for k, p in paths.items()}
    print(f"{args.images} smooth 256 px images as PNG and JPEG (quality 95) "
          f"LMDBs in {time.perf_counter() - t0:.2f} s: "
          + ", ".join(f"{k} {v:.1f} MiB" for k, v in sizes.items()))
    figures = {}
    for fmt, path in paths.items():
        pil = MultiResolutionDataset(path, resolution=256)
        rate, _ = decode_rate(lambda: pil_batches(path), args.batches)
        rates = {"pil": rate}
        for threads in THREADS:
            rates[threads], first = decode_rate(
                lambda: native_batches(path, threads), args.batches)
            err = max(float(np.abs(first[i] - pil[i]).max())
                      for i in range(BATCH))
            cs.check(err <= cs.LOADER_TOL, f"{fmt}, {threads} threads: "
                     f"{err:.3e} from PIL's decode")
        next_ms, move_ms = copy_ms(path, dev)
        figures[fmt] = {"decode": rates, "next_ms": next_ms,
                        "to_card_ms": move_ms}
        print(f"{fmt} decode, batches of {BATCH}, {args.batches} batches "
              f"({args.batches * BATCH} images): PIL loader "
              f"{rates['pil']:.1f} imgs/s; native loader "
              + ", ".join(f"{t} threads {rates[t]:.1f}" for t in THREADS)
              + f" imgs/s (depth {DEPTH}); a decoded batch's next() "
              f"{next_ms:.2f} ms, its move to the card {move_ms:.2f} ms "
              f"[{card}]")

    ckpt = os.path.join(d, "stn.pt")
    cs.make_checkpoint(ckpt)
    model, _ = cs.load_stn(ckpt, supersize=256, device=dev)
    sources = {"PIL loader": lambda path: iter(pil_batches(path))}
    for threads in FED_THREADS:
        sources[f"native loader, {threads} threads"] = \
            lambda path, t=threads: native_batches(path, t)
    sources["batches in memory"] = lambda path: held_batches(
        [b for _, b in zip(range(11), pil_batches(path))])
    for fmt, path in paths.items():
        for name, make in sources.items():
            batches = make(path)
            fed(model, dev, batches, WARM)
            seconds, waited, count = fed(model, dev, batches, args.batches)
            trace_dir = os.path.join(d, f"trace_{fmt}_{len(figures[fmt])}")
            with trace(trace_dir):
                traced_s, traced_wait, _ = fed(model, dev, batches, TRACED)
            batches.close()
            busy, span, _ = cs.trace_busy(trace_dir)
            row = {"imgs_s": count / seconds,
                   "wait_share": waited / seconds,
                   "busy_ms": busy, "span_ms": span,
                   "idle": 1 - busy / span}
            figures[fmt][name] = row
            print(f"{fmt}, congeal forward at batch {BATCH} fed by the "
                  f"{name}: {row['imgs_s']:.1f} imgs/s over {count} images in "
                  f"{seconds:.3f} s, {waited:.3f} s of it waiting for "
                  f"batches ({row['wait_share']:.4f}); {TRACED} traced "
                  f"batches: device busy {busy:.3f} of {span:.3f} ms, idle "
                  f"share {row['idle']:.4f} ({traced_wait:.3f} s of "
                  f"{traced_s:.3f} s waiting) [{card}]")
    shutil.rmtree(d)
    print(card)
    print(json.dumps({"loader": figures, "card": card}))


if __name__ == "__main__":
    sys.exit(main())
