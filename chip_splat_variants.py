"""Time design variants of K6 (gangealing_torch/csrc/splat.cu) on one CUDA
card, at the AR path's shapes and on a dense label over large images.

Each variant is the source with a few textual edits (``VARIANTS``), built
by nvcc with the library's flags into ``build/variants_splat/<name>/`` (all
builds started together) and launched through its C entry point as the
object-and-mask pair. The AR path's inputs are those that one batch of 50
frames of apps/mixed_reality.run_gangealing_on_video gave K6, with the
flagship STN and chip_smoke.py's synthetic 4,060-point label at sigma 1.2;
the large shape is chip_smoke.py's dense 256^2 label over 8 images of 1024
px. Every variant is held against the plain pair (1e-5 scaled by
max(1, max|ref|)) before its device time per call is printed
(chip_smoke.device_ms over 50 launches), with ptxas's register count and
spills and the card's name and power limit; a diagnostic variant, which
computes something else, is only timed.

    python3 chip_splat_variants.py
"""

import ctypes
import os
import re
import shutil
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import torch

import chip_smoke as cs
from gangealing_torch import _build
from gangealing_torch.apps.common import load_stn
from gangealing_torch.ops import splat as splat_ops

HIT = "hit = (win & 255) <= sy0 + kSubH - 1"
LB = "__launch_bounds__(kThreads, 4)"
SUMS = "for (int k0 = 0; k0 < count; k0 += 32) {"
CULLS = [("          gather(count);\n", "", 1),
         ("    if (count > 0) gather(count);\n", "", 1)]
# name: (edits of the source, each (old, new, count); whether the output is
# held against the plain pair: a diagnostic variant computes something
# else and is only timed)
VARIANTS = {
    "as committed": ([], True),
    "no near test": ([("if (__any_sync(0xffffffffu, any)) {", "if (true) {",
                       1)], True),
    "32 x 32 tiles, 2 x 1 a block": ([("kTile = 16;", "kTile = 32;", 1),
                                      ("kRegionX = 4;", "kRegionX = 2;", 1),
                                      ("kRegionY = 2;", "kRegionY = 1;", 1)],
                                     True),
    "1 x 1 tile a block": ([("kRegionX = 4;", "kRegionX = 1;", 1),
                            ("kRegionY = 2;", "kRegionY = 1;", 1)], True),
    "4 x 4 tiles a block": ([("kRegionY = 2;", "kRegionY = 4;", 1)], True),
    "8 x 2 tiles a block": ([("kRegionX = 4;", "kRegionX = 8;", 1)], True),
    "3 blocks an SM": ([(LB, "__launch_bounds__(kThreads, 3)", 1)], True),
    "a tile list of 128": ([("kList = 192;", "kList = 128;", 1)], True),
    "a tile list of 384": ([("kList = 192;", "kList = 384;", 1)], True),
    "2 points a thread a round": ([("kPerThread = 4;", "kPerThread = 2;",
                                    1)], True),
    # a dense tile gather: every listed point in every sub-region
    "no sub-region ballot": ([(HIT, "hit = true || (win & 255) <= sy0 + "
                               "kSubH - 1", 1)], True),
    # diagnostics: the culls and the weights without the sums; the weights
    # without their exponentials; the culls alone; the region's cull and
    # the output alone
    "no sums": ([(SUMS, "for (int k0 = 0; k0 < 0 * count; k0 += 32) {", 1)],
                False),
    "no expf": ([("g = expf(norm * (d * d));", "g = d;", 1)], False),
    "culls only": (CULLS, False),
    "region cull only": (CULLS + [(
        "for (int base = 0; base < rcount; base += kRound) {",
        "for (int base = 0; base < 0 * rcount; base += kRound) {", 1)],
        False),
}
ROOT = os.path.join("build", "variants_splat")


def build(name):
    """Build one variant's splat.cu into a library; return its path and
    ptxas's register count of the kernel."""
    d = os.path.join(ROOT, re.sub(r"\W+", "_", name))
    shutil.copytree(_build.CSRC, d)
    path = os.path.join(d, "splat.cu")
    src = open(path).read()
    for old, new, count in VARIANTS[name][0]:
        cs.check(src.count(old) == count, f"{name}: {old!r} not found")
        src = src.replace(old, new)
    open(path, "w").write(src)
    so = os.path.join(d, "lib.so")
    log = _build._nvcc_run(name, [*_build.NVCC_FLAGS, "-shared", "-o", so,
                                  path])
    regs = re.findall(r"(\d+) bytes spill stores.*?Used (\d+) registers",
                      log, re.S)
    return so, regs[0] if regs else None


def path_inputs(dev):
    """K6's inputs from one AR batch of the flagship STN."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "stn.pt")
        cs.make_checkpoint(path)
        model, _ = load_stn(path, supersize=256, device=dev)
    label, _ = cs.synthetic_label()
    frames = cs.smooth_images(cs.AR_BATCH,
                              torch.Generator().manual_seed(8)).numpy()
    with cs.recorded(splat_ops, "splat2d_pair_cuda") as k6:
        cs.ar_run(model, frames, label)
    cs.check(len(k6) == 1, f"the AR batch launched K6 {len(k6)} times")
    return k6[0][0]


def main():
    shutil.rmtree(ROOT, ignore_errors=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(build, VARIANTS)))
    dev, card = cs.setup()
    cases = {"AR path": path_inputs(dev), "dense 256^2 label, 8 x 1024^2":
             cs.dense_label_args(dev)}
    refs = {what: splat_ops.splat2d_pair(*args, max_sigma=cs.AR_SIGMA)
            for what, args in cases.items()}
    for what, args in cases.items():
        ms = cs.device_ms(lambda: splat_ops.splat2d_pair_cuda(*args),
                          iters=50, per_call=1)
        print(f"the library's splat2d_pair_cuda on the {what} inputs: "
              f"{ms:.4f} ms [{card}]")
    coords = cases["AR path"][0]
    x, y = coords[..., 0], coords[..., 1]
    vis = (x >= 0) & (x < 256) & (y >= 0) & (y < 256)
    print(f"AR path points: {int(vis.sum())} of {vis.numel()} visible, x in "
          f"[{float(x[vis].min()):.1f}, {float(x[vis].max()):.1f}], y in "
          f"[{float(y[vis].min()):.1f}, {float(y[vis].max()):.1f}]")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    stream = _build.stream_of(dev)
    for name, (so, regs) in built.items():
        fn = ctypes.CDLL(so).gg_splat_fwd
        fn.argtypes = [ptr] * 8 + [i32] * 7 + [ptr]
        fn.restype = i32
        res = []
        for what, (coords, obj_v, mask_v, sigma, H, W) in cases.items():
            N, P = coords.shape[:2]
            obj = torch.empty(N, obj_v.shape[2], H, W, device=dev)
            mask = torch.empty(N, mask_v.shape[2], H, W, device=dev)

            def run():
                cs.check(fn(coords.data_ptr(), sigma.data_ptr(),
                            obj_v.data_ptr(), None, obj.data_ptr(),
                            mask_v.data_ptr(), None, mask.data_ptr(), N, P,
                            obj_v.shape[2], mask_v.shape[2], H, W, dev.index,
                            stream) == 0, f"{name}: launch failed")
            run()
            err = max(cs.scaled_err(o, r)[1]
                      for o, r in zip((obj, mask), refs[what]))
            cs.check(err <= cs.KERNEL_TOL or not VARIANTS[name][1],
                     f"{name}: {what} off by {err}")
            res.append(f"{what} "
                       f"{cs.device_ms(run, iters=50, per_call=1):.4f}")
        print(f"{name} (registers {regs[1]}, spill stores {regs[0]} bytes), "
              f"ms a call: {', '.join(res)} [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
