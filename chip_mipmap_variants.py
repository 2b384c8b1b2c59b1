"""Time design variants of K1 and K3 (gangealing_torch/csrc/mipmap_sample.cu)
on one CUDA card, at the main path's shapes.

Each variant is the source with a few textual edits (``VARIANTS``), built
by nvcc with the library's flags into ``build/variants/<name>/`` (all
builds started together) and launched through its C entry points. K1 runs
on the pyramid, grid and levels that each head of a served flagship
congeal forward gave it at batch 40 and 128; K3 on each batch-40 head's
grid over a (40, 3, 128, 128) image, the train step's shapes. Every
variant but a diagnostic one is held against ``_sample_pyramid`` (K1,
1e-5) and its autograd (K3, 1e-5 scaled by max(1, max|ref|)) before its
device time (torch.profiler) is printed, with ptxas's register counts, the
count of SASS instructions in each kernel's code (static, every path
counted once) and the card's name and power limit.

    python3 chip_mipmap_variants.py
"""

import ctypes
import os
import re
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import torch

import chip_smoke as cs
from gangealing_torch import _build
from gangealing_torch.apps.common import load_stn
from gangealing_torch.ops import mipmap as mm

LB = "__launch_bounds__(kTileX* kTileY)"
LOAD = "win[a][b] = __ldg(l4 + (r.row[a] + r.col[b]) * G + g);"
SKIP = ("win[a][b] = (a < 2 || r.ky) && (b < 2 || r.kx) ? "
        "__ldg(l4 + (r.row[a] + r.col[b]) * G + g) : "
        "make_float4(0.f, 0.f, 0.f, 0.f);")
LANE_W = "      t.w = __fmaf_rn(A[a][b], win[a][b].w, t.w);\n"
LEVEL0 = "v[k] = __ldg(plane + q.off0[k]);"
DIV = """  const int y0 = q.t.off[0] / p.W, y1 = q.t.off[2] / p.W;
  q.Y0 = y0 + p.lp;
  q.Y1 = y1 + p.lp;
  q.X0 = q.t.off[0] - y0 * p.W + p.lp;
  q.X1 = q.t.off[1] - y0 * p.W + p.lp;
"""
NODIV = """  float sx, sy;
  const float x0 = floorf(gg::source_coord<PAD>(gx, p.W, &sx));
  const float y0 = floorf(gg::source_coord<PAD>(gy, p.H, &sy));
  q.X0 = (int)fminf(fmaxf(x0, 0.f), (float)(p.W - 1)) + p.lp;
  q.X1 = (int)fminf(fmaxf(x0 + 1.f, 0.f), (float)(p.W - 1)) + p.lp;
  q.Y0 = (int)fminf(fmaxf(y0, 0.f), (float)(p.H - 1)) + p.lp;
  q.Y1 = (int)fminf(fmaxf(y0 + 1.f, 0.f), (float)(p.H - 1)) + p.lp;
"""
# name: (edits of the source, each (old, new, count); whether the coarse
# levels are packed without padding the channels to float4; whether the
# output is held against the plain version: a diagnostic variant computes
# something else and is only timed)
VARIANTS = {
    "as committed": ([], False, True),
    "32 x 8 tiles": ([("kTileY = 4;", "kTileY = 8;", 1)], False, True),
    "16 x 16 tiles": ([("kTileX = 32;", "kTileX = 16;", 1),
                       ("kTileY = 4;", "kTileY = 16;", 1)], False, True),
    "at least 3 blocks an SM": ([(LB, "__launch_bounds__(kTileX * kTileY, 3)",
                                  2)], False, True),
    "at least 4 blocks an SM": ([(LB, "__launch_bounds__(kTileX * kTileY, 4)",
                                  2)], False, True),
    # the window's third row (column) is read only where the second corner
    # row's (column's) source row starts one past the first's
    "third row and column only where read": ([(LOAD, SKIP, 1)], False, True),
    # 12-byte texels: three scalar loads in place of one float4 (C = 3 only)
    "unpadded 12-byte texels": ([
        (LOAD, "{ const float* t = level + (r.row[a] + r.col[b]) * 3; "
               "win[a][b] = make_float4(__ldg(t), __ldg(t + 1), "
               "__ldg(t + 2), 0.f); }", 1),
        ("off += (int64_t)4 * p->G * p->size[d] * p->size[d];",
         "off += (int64_t)3 * p->size[d] * p->size[d];", 1)], True, True),
    # K1's filter on three lanes of the float4 (C = 3 only)
    "K1 filter on three lanes": ([(LANE_W, "", 1)], False, True),
    # one kernel for every channel count, as for C != 3
    "no three-channel form": ([
        ("C == 3 ? launch_fwd<3>", "C == -1 ? launch_fwd<3>", 1),
        ("C == 3 ? launch_dcoords<3>", "C == -1 ? launch_dcoords<3>", 1)],
        False, True),
    # the corners' rows and columns clamped as set_corner clamps them, in
    # place of two integer divisions of their offsets
    "corner rows without a division": ([(DIV, NODIV, 1)], False, True),
    # every load of the pyramid replaced by a value of its index: the time
    # of the rest (the grid and levels, the arithmetic, the stores)
    "diagnostic: no pyramid loads": ([
        (LOAD, "win[a][b] = make_float4((float)(r.row[a] + r.col[b]), "
               "0.f, 0.f, 0.f);", 1),
        (LEVEL0, "v[k] = (float)q.off0[k];", 1)], False, False),
}
ROOT = os.path.join("build", "variants")


def build(name):
    """Build one variant's mipmap_sample.cu into a library; return its path
    and ptxas's register counts of the K1 and K3 kernels."""
    edits = VARIANTS[name][0]
    d = os.path.join(ROOT, re.sub(r"\W+", "_", name))
    shutil.copytree(_build.CSRC, d)
    path = os.path.join(d, "mipmap_sample.cu")
    src = open(path).read()
    for old, new, count in edits:
        cs.check(src.count(old) == count, f"{name}: {old!r} not found")
        src = src.replace(old, new)
    open(path, "w").write(src)
    so = os.path.join(d, "lib.so")
    log = _build._nvcc_run(name, [*_build.NVCC_FLAGS, "-shared", "-o", so,
                                  path])
    regs = re.findall(r"Compiling entry function '\w*?pyramid_(fwd|dcoords)"
                      r"_kernelILi0ELi3E[^']*'.*?Used (\d+) registers", log,
                      re.S)
    return so, dict(regs), sass_counts(so)


def sass_counts(so):
    """The SASS instructions in the code of the K1 and K3 kernels that the
    main path launches (border padding, 3 channels)."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True,
                          text=True, check=True).stdout
    counts = {}
    for fn in sass.split("Function : ")[1:]:
        m = re.match(r"\w*?pyramid_(fwd|dcoords)_kernelILi0ELi3E", fn)
        if m:
            counts[m.group(1)] = len(re.findall(r"/\*[0-9a-f]{4}\*/", fn))
    return counts


def unpadded(pyramid):
    """The coarse levels packed [row][column][channel], channels unpadded."""
    n = pyramid.level0.shape[0]
    return torch.cat([lv.permute(0, 2, 3, 1).reshape(n, -1)
                      for lv in mm._pyramid_levels(pyramid)[1:]], 1)


def main():
    shutil.rmtree(ROOT, ignore_errors=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(build, VARIANTS)))
    dev, card = cs.setup()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "stn.pt")
        cs.make_checkpoint(path)
        model, _ = load_stn(path, supersize=256, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    k1_cases, k3_cases = [], []
    for b in cs.BATCHES:
        x = torch.rand(b, 3, 256, 256, device=dev, generator=g) * 2 - 1
        with cs.recorded(mm, "mipmap_sample") as calls:
            cs.congeal(model, x)
        for head, (args, out) in zip(("similarity", "flow"), calls):
            k1_cases.append((f"K1 {head} {b}", args, out))
            if b != cs.TRAIN_BATCH:
                continue
            grid = args[1]
            img = torch.rand(b, 3, 128, 128, device=dev, generator=g) * 2 - 1
            pyr = mm._build_pyramid(img, 4)
            lv = mm.jmax(mm.mipmap_levels(grid, 128, 128, 3.5),
                         0.0).contiguous()
            dout = torch.randn(out.shape, device=dev, generator=g)
            gr, lr = grid.clone().requires_grad_(), lv.clone().requires_grad_()
            ref = torch.autograd.grad(
                mm._sample_pyramid(pyr, gr, lr, "border"), (gr, lr), dout)
            k3_cases.append((f"K3 {head} {b}", (pyr, grid, lv, dout), ref))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    stream = _build.stream_of(dev)
    for name, (so, regs, sass) in built.items():
        lib = ctypes.CDLL(so)
        fwd, dco = lib.gg_mipmap_pyramid_fwd, lib.gg_mipmap_pyramid_dcoords
        fwd.argtypes = [ptr] * 5 + [i32] * 11 + [ptr]
        dco.argtypes = [ptr] * 7 + [i32] * 11 + [ptr]
        fwd.restype = dco.restype = i32
        _, flat, checked = VARIANTS[name]
        res = []
        for what, (pyr, grid, lv, pm), ref in k1_cases:
            coarse = unpadded(pyr) if flat else pyr.coarse
            out = torch.empty_like(ref)

            def run():
                cs.check(fwd(pyr.level0.data_ptr(), coarse.data_ptr(),
                             grid.data_ptr(), lv.data_ptr(), out.data_ptr(),
                             *mm._pyramid_args(pyr), *grid.shape[1:3],
                             _build.padding_code(pm), dev.index, stream) == 0,
                         f"{name}: K1 launch failed")
            run()
            err = float((out - ref).abs().max())
            cs.check(err <= cs.KERNEL_TOL or not checked,
                     f"{name}: {what} off by {err}")
            res.append(f"{what} {cs.device_ms(run, iters=50):.4f}")
        for what, (pyr, grid, lv, dout), ref in k3_cases:
            coarse = unpadded(pyr) if flat else pyr.coarse
            dg, dl = torch.empty_like(grid), torch.empty_like(lv)

            def run():
                cs.check(dco(pyr.level0.data_ptr(), coarse.data_ptr(),
                             grid.data_ptr(), lv.data_ptr(), dout.data_ptr(),
                             dg.data_ptr(), dl.data_ptr(),
                             *mm._pyramid_args(pyr), *grid.shape[1:3],
                             _build.padding_code("border"), dev.index,
                             stream) == 0, f"{name}: K3 launch failed")
            run()
            err = max(cs.scaled_err(o, r)[1] for o, r in zip((dg, dl), ref))
            cs.check(err <= cs.KERNEL_TOL or not checked,
                     f"{name}: {what} off by {err}")
            res.append(f"{what} {cs.device_ms(run, iters=50):.4f}")
        print(f"{name} (registers: K1 {regs.get('fwd')}, K3 "
              f"{regs.get('dcoords')}; SASS instructions: K1 "
              f"{sass.get('fwd')}, K3 {sass.get('dcoords')}), device ms: "
              f"{', '.join(res)} [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
