"""Time K2 and K5b (gangealing_torch/csrc/grid_sample.cu) at the main
path's shapes on one CUDA card, and K5b's design variants.

    python3 chip_grid_sample_variants.py             # this tree, variants too
    python3 chip_grid_sample_variants.py --tree DIR  # the package under DIR

With ``--tree`` the ``gangealing_torch`` under DIR (an unpacked earlier
commit, say) is imported in place of this tree's, its kernels built under
DIR, and only its committed kernels are timed, so two trees compare in one
call. The shapes: K2 on the AR app's flow grid, (50, 128, 128, 2) handed
over permuted as (50, 2, 128, 128), at 4,060 points an image (the whole
grid_sample_auto call, with any copy of the input it makes, and K2's kernel
alone, beside the copy itself) and on a (40, 3, 256, 256) source at a
128 x 128 similarity grid, as the antialias=False warp takes it; K5b on a
(40, 3, 128, 128) image from 128 x 128 points of a similarity grid (the
train phase's check), of a zoom-in and of a border pile (chip_smoke.SKEWED),
under border padding. Each beside its plain version, F.grid_sample and its
bound, each K5b held against the plain autograd (1e-5 scaled by
max(1, max|ref|)). Without ``--tree``, each variant of ``VARIANTS`` is
grid_sample.cu with a few textual edits, built by nvcc with the library's
flags into ``build/variants_grid_sample/<name>/`` (all builds started
together), called through its C entry points, held against the plain
autograd and timed on the same K5b inputs; a diagnostic variant computes
something else and is only timed. Each K5b time is beside the split of the
committed K5b's time among its three kernels.
"""

import argparse
import ctypes
import importlib.util
import os
import re
import shutil
import sys
from concurrent.futures import ThreadPoolExecutor

import torch


def parse():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=None,
                    help="a directory holding another gangealing_torch")
    return ap.parse_args()


ARGS = parse() if __name__ == "__main__" else argparse.Namespace(tree=None)
if ARGS.tree:
    sys.path.insert(0, os.path.abspath(ARGS.tree))

# this tree's chip_smoke.py, whichever package it then imports
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
sys.modules["chip_smoke"] = cs
_spec.loader.exec_module(cs)
import gangealing_torch  # noqa: E402
from gangealing_torch import _build  # noqa: E402
from gangealing_torch.ops import grid_sample as gs  # noqa: E402

# name: edits of csrc/ (grid_sample.cu or the bin stage it shares with K5a,
# binned.cuh), each (old, new, count)
SUMS = "for (int j = sh.run[k]; j < end; ++j) {"
DOUT = "d[r][c] = p[r] >= 0 && c < C ? dn[(int64_t)c * P + p[r]] : 0.f;"
COUNT = ("      const Group gr = group_of(key[r]);\n"
         "      if (key[r] >= 0 && gr.lead) {\n        sh.cnt")
VARIANTS = {
    "as committed": [],
    "items of 64": [("kSlots = 128;", "kSlots = 64;", 1)],
    "items of 256": [("kSlots = 128;", "kSlots = 256;", 1)],
    "16 x 8 tiles": [("kTileH = 4;", "kTileH = 8;", 1)],
    "8 x 8 tiles": [("kTileW = 16;", "kTileW = 8;", 1),
                    ("kTileH = 4;", "kTileH = 8;", 1)],
    "32 x 4 tiles": [("kTileW = 16;", "kTileW = 32;", 1)],
    "8 warps a gather block": [("kGatherWarps = 4;", "kGatherWarps = 8;", 1)],
    "clusters of 4 bin blocks": [("kCluster = 8;", "kCluster = 4;", 1)],
    "bin loads 4 rounds at a time": [("kBinRounds = 8;", "kBinRounds = 4;",
                                      1)],
    "at most 40 gather registers": [
        ("__launch_bounds__(kGatherWarps * 32)\n    dimg_gather_kernel",
         "__launch_bounds__(kGatherWarps * 32, 12)\n    dimg_gather_kernel",
         1)],
    # diagnostics, not held against the plain version, with every store
    # still read: the sums over one point a run; dout read as a constant;
    # 8 more __match_any_sync an item
    "diagnostic: one point a run": [(SUMS, "for (int j = sh.run[k]; "
                                     "j < min(end, sh.run[k] + 1); ++j) {", 1)],
    "diagnostic: no dout loads": [(DOUT, "d[r][c] = 1.f;", 1)],
    "diagnostic: 8 more matches": [
        (COUNT, "      if (group_of(key[r] + 7).mask == 0) sh.cnt[0] = 1;\n"
         + COUNT, 1)],
}
ROOT = os.path.join("build", "variants_grid_sample")
# K5b's kernels, by a part of their names
STAGES = {"bin": "bin_kernel", "gather": "dimg_gather_kernel",
          "merge": "dimg_merge_kernel"}


def build(name):
    d = os.path.join(ROOT, re.sub(r"\W+", "_", name))
    shutil.copytree(_build.CSRC, d)
    path = os.path.join(d, "grid_sample.cu")
    files = {f: open(os.path.join(d, f)).read()
             for f in ("grid_sample.cu", "binned.cuh")}
    for old, new, count in VARIANTS[name]:
        cs.check(sum(s.count(old) for s in files.values()) == count,
                 f"{name}: {old!r} not found")
        files = {f: s.replace(old, new) for f, s in files.items()}
    for f, s in files.items():
        open(os.path.join(d, f), "w").write(s)
    so = os.path.join(d, "lib.so")
    log = _build._nvcc_run(name, [*_build.NVCC_FLAGS, "-shared", "-o", so,
                                  path])
    regs = re.findall(r"Compiling entry function '\w*?(dimg_gather|"
                      r"dimg_merge|bin)_kernel(?:ILi0E|INS_8DimgKeysILi0E)?"
                      r"\w*'.*?Used (\d+) registers", log, re.S)
    return so, dict(regs)


def similarity_grid(N, size, dev, seed):
    """Per image a rotation within 0.3 rad, a scale within 0.8-1.25 and a
    shift within 0.1: a similarity head's grid."""
    g = torch.Generator().manual_seed(seed)
    a = (torch.rand(N, generator=g) * 2 - 1) * 0.3
    s = torch.exp((torch.rand(N, generator=g) * 2 - 1) * 0.22)
    t = (torch.rand(N, 2, generator=g) * 2 - 1) * 0.1
    theta = torch.stack([
        torch.stack([s * a.cos(), -s * a.sin(), t[:, 0]], 1),
        torch.stack([s * a.sin(), s * a.cos(), t[:, 1]], 1)], 1)
    return cs.affine_grid(theta, (N, 1, size, size)).contiguous().to(dev)


def k5b_ref(grid, dout, shape):
    x = torch.zeros(shape, device=grid.device, requires_grad=True)
    return torch.autograd.grad(cs.grid_sample(x, grid), x, dout)[0]


def main():
    dev, card = cs.setup()
    print(f"gangealing_torch from {os.path.dirname(gangealing_torch.__file__)}")
    g = torch.Generator(device=dev).manual_seed(13)

    # K2, the AR app's shape: the flow grid handed over permuted
    grid_b = (similarity_grid(cs.AR_BATCH, 128, dev, 14) + 0.05 * torch.randn(
        cs.AR_BATCH, 128, 128, 2, device=dev, generator=g)).contiguous()
    view = grid_b.permute(0, 3, 1, 2)
    label = cs.synthetic_label()[0][0].to(dev)  # (1, P, 2) pixels of 128
    points = ((label + 0.5) / 64 - 1).repeat(cs.AR_BATCH, 1, 1)[:, :, None]
    t = cs.k2_times(view, points.contiguous())
    copy_ms = cs.device_ms(lambda: view.contiguous())
    cs.print_k2(f"at the AR app's shape (the contiguous copy alone "
                f"{copy_ms:.4f} ms)", view, points, t, card)
    # K2, the antialias=False warp's shape
    src = torch.rand(40, 3, 256, 256, device=dev, generator=g) * 2 - 1
    warp_grid = similarity_grid(40, 128, dev, 15)
    cs.print_k2("at the antialias=False warp's shape", src, warp_grid,
                cs.k2_times(src, warp_grid), card)

    # K5b at the train phase's check and on the skewed grids
    shape = (40, 3, 128, 128)
    dout = torch.randn(40, 3, 128, 128, device=dev, generator=g)
    grids = {"similarity": similarity_grid(40, 128, dev, 16)}
    grids.update({k: cs.scaled_grid(40, 128, s, dev)
                  for k, s in cs.SKEWED.items()})
    refs = {k: k5b_ref(v, dout, shape) for k, v in grids.items()}
    per_call = None if ARGS.tree else cs.K5B_KERNELS
    for kind, grid in grids.items():
        err = cs.scaled_err(gs.grid_sample_dimg(grid, dout, shape, "border"),
                            refs[kind])
        cs.check(err[1] <= cs.KERNEL_TOL, f"K5b on {kind} off by {err}")
        t = cs.k5b_times(grid, dout, shape, per_call=per_call)
        print(f"K5b on the {kind} grid, {shape}, border, device time: "
              f"kernels {t[0]:.4f} ms, plain autograd {t[1]:.4f} ms, backward "
              f"of F.grid_sample to the image {t[4]:.4f} ms; bound {t[2]:.4f} "
              f"ms ({t[3]}); max abs err {err[0]:.3e} [{card}]")
        if not ARGS.tree:
            split = {k: cs.device_ms(lambda: gs.grid_sample_dimg(
                grid, dout, shape, "border"), name=v,
                per_call=1) for k, v in STAGES.items()}
            print(f"  K5b's kernels on it: " + ", ".join(
                f"{k} {ms:.4f} ms" for k, ms in split.items()))
    if ARGS.tree:
        return 0

    shutil.rmtree(ROOT, ignore_errors=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(build, VARIANTS)))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    stream = _build.stream_of(dev)
    for name, (so, regs) in built.items():
        lib = ctypes.CDLL(so)
        size = lib.gg_grid_sample_dimg_scratch
        size.argtypes, size.restype = [i32] * 5, ctypes.c_longlong
        fn = lib.gg_grid_sample_dimg
        fn.argtypes, fn.restype = [ptr] * 4 + [i32] * 7 + [ptr], i32
        res = []
        for kind, grid in grids.items():
            out = torch.empty(shape, device=dev)
            scratch = torch.empty(size(*shape, 128 * 128), device=dev,
                                  dtype=torch.uint8)

            def run():
                cs.check(fn(grid.data_ptr(), dout.data_ptr(), out.data_ptr(),
                            scratch.data_ptr(), *shape, 128 * 128,
                            _build.padding_code("border"), dev.index,
                            stream) == 0, f"{name}: K5b launch failed")
            run()
            err = cs.scaled_err(out, refs[kind])[1]
            cs.check(err <= cs.KERNEL_TOL or name.startswith("diagnostic"),
                     f"{name}: {kind} off by {err}")
            ms = cs.device_ms(run, iters=50, per_call=cs.K5B_KERNELS)
            res.append(f"{kind} {ms:.4f}")
        print(f"K5b variant {name} (registers {regs}), device ms: "
              f"{', '.join(res)} [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
