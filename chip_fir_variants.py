"""Time design variants of the FIR kernel (csrc/upfirdn2d.cu) on one card.

    python3 chip_fir_variants.py

Each variant is a textual edit of the kernel's source, built by nvcc with
the port's flags into its own library under build/fir_variants/ and called
through its C entry point, at the shapes the benchmark's cells run: the
congeal cell's STN blurs and their gradients, the cats step's G blurs and
their gradients, and ToRGB's upsample2x and its gradient. Each call is
checked against the plain version (F.pad and ATen's depthwise conv),
whose bits it should give, and timed with CUDA events over 30 calls after
3; the bound is the bytes in and out over 3.35 TB/s. The shapes' gradients
run as forwards here (the order of their sums aside, the same work).
Needs a CUDA card; takes about a minute.
"""

import ctypes
import os
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from gangealing_torch import _build
from gangealing_torch.ops import resample as rs

SRC = (Path(__file__).resolve().parent / "gangealing_torch" / "csrc"
       / "upfirdn2d.cu").read_text()
OUT = _build.BUILD_DIR.parent / "fir_variants"
HBM_BYTES_PER_S = 3.35e12
BLUR = (1, 3, 3, 1)
# (N, C, side, gain, up, down, pads x0, x1, y0, y1)
SHAPES = {
    "congeal fwd 128 x64 x50 p2": (50, 64, 128, 1, 1, 1, (2, 2, 2, 2)),
    "congeal dx 129 x64 x50 p1": (50, 64, 129, 1, 1, 1, (1, 1, 1, 1)),
    "congeal fwd 32 x512 x50 p2": (50, 512, 32, 1, 1, 1, (2, 2, 2, 2)),
    "congeal fwd 8 x512 x50 p2": (50, 512, 8, 1, 1, 1, (2, 2, 2, 2)),
    "cats G fwd 257 x128 x40 p1": (40, 128, 257, 4, 1, 1, (1, 1, 1, 1)),
    "cats G dx 256 x128 x40 p2": (40, 128, 256, 4, 1, 1, (2, 2, 2, 2)),
    "cats G fwd 129 x256 x40 p1": (40, 256, 129, 4, 1, 1, (1, 1, 1, 1)),
    "up2 128->256 x3 x40": (40, 3, 128, 4, 2, 1, (2, 1, 2, 1)),
    "down2 256->128 x3 x40": (40, 3, 256, 4, 1, 2, (1, 1, 1, 1)),
}

def sub(src, old, new):
    if old not in src:
        raise ValueError(f"variant edit does not apply: {old[:60]!r}")
    return src.replace(old, new)


def variants():
    return {
        "kernel": SRC,
        "rows in flight 4": sub(SRC, "kRowsInFlight = 8", "kRowsInFlight = 4"),
        "rows in flight 16": sub(SRC, "kRowsInFlight = 8",
                                 "kRowsInFlight = 16"),
        "threads 128": sub(SRC, "kThreads = 256", "kThreads = 128"),
        "tile rows 16": sub(SRC, "kMaxTileH = 32", "kMaxTileH = 16"),
        "tile columns 32": sub(SRC, "kMaxTileW = 64", "kMaxTileW = 32"),
    }


def build(name, src):
    stem = re.sub(r"\W+", "_", name)
    cu, so = OUT / f"{stem}.cu", OUT / f"lib{stem}.so"
    cu.write_text(src)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                           "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stderr[-3000:]}")
    regs = re.findall(r"Used (\d+) registers", proc.stdout + proc.stderr)
    lib = ctypes.CDLL(str(so))
    lib.gg_upfirdn2d.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 10 \
        + [ctypes.c_void_p] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    lib.gg_upfirdn2d.restype = ctypes.c_int
    return name, lib, regs


def events_ms(fn, iters=30):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_fir_variants.py needs a CUDA card")
    OUT.mkdir(parents=True, exist_ok=True)
    srcs = variants()
    with ThreadPoolExecutor(len(srcs)) as pool:
        libs = list(pool.map(build, srcs, srcs.values()))
    for name, _, regs in libs:
        print(f"{name}: registers {regs}")
    print(os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip())
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    shares = {name: [] for name, _, _ in libs}
    for what, (N, C, side, gain, up, down, pads) in SHAPES.items():
        f = rs.fir(BLUR, gain)
        x = torch.randn(N, C, side, side, device=dev)
        ref = rs.upfirdn2d_plain(x, rs.fir_matrix(f).to(dev), up, down, pads)
        y = torch.empty_like(ref)
        OH, OW = ref.shape[-2:]
        taps = rs.kernel_taps(f)
        bound = (x.numel() + y.numel()) * 4 / HBM_BYTES_PER_S * 1e3
        print(f"{what}: bound {bound:.4f} ms")
        for name, lib, _ in libs:
            def call():
                rc = lib.gg_upfirdn2d(x.data_ptr(), y.data_ptr(), 0, N * C,
                                      side, side, OH, OW, up, down, pads[0],
                                      pads[2], taps, 0, dev.index, stream)
                if rc:
                    raise RuntimeError(f"{name}: CUDA error {rc}")
            y.fill_(float("nan"))
            call()
            apart = int((y != ref).sum())
            ms = events_ms(call)
            shares[name].append(bound / ms)
            print(f"  {name}: {ms:.4f} ms, {bound / ms:.1%} of the bound, "
                  f"{apart} values apart from the plain version's bits")
        del x, y, ref
        torch.cuda.empty_cache()
    for name, s in shares.items():
        print(f"{name}: share of the bound, geometric mean "
              f"{statistics.geometric_mean(s):.1%}, least {min(s):.1%}")


if __name__ == "__main__":
    sys.exit(main())
