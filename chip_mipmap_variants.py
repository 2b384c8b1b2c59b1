"""Time K5a's route and design variants of K1, K3 and K5a
(gangealing_torch/csrc/mipmap_sample.cu) on one CUDA card, at the main
path's shapes.

    python3 chip_mipmap_variants.py             # this tree, variants too
    python3 chip_mipmap_variants.py --tree DIR  # the package under DIR

K5a's route, from d/dout to the pyramid's gradient (d/dlevel0,
d/dcoarse) as ``MipmapSample.backward`` takes it, is timed on each head's grid of a served batch-40 flagship
forward over a (40, 3, 128, 128) image (the train phase's check) and over
the (40, 3, 256, 256) source at the levels that forward gave K1, and on a
zoom-in and a border pile (chip_smoke.SKEWED) over the 128 image; beside
its plain autograd, the backward of F.grid_sample to the full-resolution
stack as a volume (d/dstack alone, less work than the route) and two
bounds: bytes that write the full-resolution stack (the old count) and
bytes that write the pyramid's gradient once (the new). A tree whose
K5a still scatters a d/dstack is timed in its parts: the zero fill and
the torch adjoint of the rebuild (``chip_smoke.parent_route_ms``) and the
scatter, the route's one kernel named mipmap. With ``--tree`` the
``gangealing_torch`` under DIR (an unpacked earlier commit, say) is
imported in place of this tree's, its kernels built under DIR, and only
K5a's route is timed, so two trees compare in one call.

Without ``--tree``, each variant is the source with a few textual edits
(``VARIANTS``, ``K5A_VARIANTS``), built by nvcc with the library's flags
into ``build/variants/<name>/`` (all builds started together) and
launched through its C entry points. K1 runs on the pyramid, grid and
levels that each head of a served flagship congeal forward gave it at
batch 40 and 128; K3 on each batch-40 head's grid over a (40, 3, 128, 128)
image, the train step's shapes; K5a on its route's inputs. Every variant
but a diagnostic one is held against ``_sample_pyramid`` (K1, 1e-5) and
its autograd (K3 and K5a, 1e-5 scaled by max(1, max|ref|)) before its
device time (torch.profiler) is printed, with ptxas's register counts, the
count of SASS instructions in each kernel's code (static, every path
counted once) and the card's name and power limit.
"""

import argparse
import ctypes
import importlib.util
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import torch
import torch.nn.functional as F


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
from gangealing_torch.apps.common import load_stn  # noqa: E402
from gangealing_torch.ops import mipmap as mm  # noqa: E402

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


# K5a's price of determinism: one thread a point adds its footprints'
# weighted dout into the pyramid's gradient with atomicAdd, after a
# memset, through its own entry point (same arguments, no scratch).
ATOMIC_K5A = r"""
namespace {
template <int PAD>
__global__ void dpyramid_atomic_kernel(Pyramid p, const float* grid,
                                       const float* levels, const float* dout,
                                       float* dlevel0, float* dcoarse, int N,
                                       int P) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)N * P) return;
  const int n = (int)(i / P);
  const int64_t pt = i - (int64_t)n * P;
  const PointTaps q = point_taps<PAD>(p, grid[2 * i], grid[2 * i + 1]);
  if (reaches_nothing(q.t)) return;
  const Tent tn = tent_of(levels[i], p.D);
  for (int e = 0; e < 2; ++e) {
    const float w = e ? tn.hi : tn.lo;
    if (w == 0.f) continue;
    const int d = tn.f + e;
    float wq[kSpan * kSpan];
    footprint_weights(p, q, d, w, wq);
    int ky, kx;
    footprint_origin(p, q, d, &ky, &kx);
    for (int c = 0; c < p.C; ++c) {
      const float g = dout[((int64_t)n * p.C + c) * P + pt];
      for (int a = 0; a < kSpan; ++a) {
        for (int b = 0; b < kSpan; ++b) {
          if (wq[a * kSpan + b] == 0.f) continue;
          float* at = group_at(p, dlevel0, dcoarse, n, d, ky + a, kx + b,
                               c / 4);
          atomicAdd(at + (c % 4) * (d == 0 ? (int64_t)p.S * p.S : 1),
                    g * wq[a * kSpan + b]);
        }
      }
    }
  }
}
}  // namespace

extern "C" int gg_mipmap_dpyramid_atomic(
    const float* grid, const float* levels, const float* dout, float* dlevel0,
    float* dcoarse, int N, int D, int C, int S, int H, int W, int lp, int P,
    int padding, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Pyramid p;
  if (!make_pyramid(&p, dlevel0, dcoarse, D, C, S, H, W, lp)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  cudaMemsetAsync(dlevel0, 0, sizeof(float) * (size_t)N * C * S * S, s);
  cudaMemsetAsync(dcoarse, 0, sizeof(float) * (size_t)N * p.coarse_stride,
                  s);
  const unsigned blocks = (unsigned)(((int64_t)N * P + 255) / 256);
  GG_LAUNCH_BY_PADDING(dpyramid_atomic_kernel, blocks, 256, s, p, grid,
                       levels, dout, dlevel0, dcoarse, N, P);
  return (int)cudaGetLastError();
}
"""
# name: edits of csrc/ (each (old, new, count), made in whichever file holds
# old; old None appends new to mipmap_sample.cu), and the entry point
K5A_VARIANTS = {
    "K5a as committed": ([], "gg_mipmap_dpyramid"),
    "K5a atomic scatter into the pyramid": ([(None, ATOMIC_K5A, 0)],
                                            "gg_mipmap_dpyramid_atomic"),
    "K5a 16 x 8 tiles": ([("kTileH = 4;", "kTileH = 8;", 1)],
                         "gg_mipmap_dpyramid"),
    "K5a 32 x 4 tiles": ([("kTileW = 16;", "kTileW = 32;", 1)],
                         "gg_mipmap_dpyramid"),
    "K5a one bin pass up to 5,632 keys": ([("kPassKeys = 4096;",
                                            "kPassKeys = 5632;", 1)],
                                          "gg_mipmap_dpyramid"),
    "K5a gather at most 64 registers": ([(
        "__launch_bounds__(kGatherWarps * 32)\n    dpyramid_gather_kernel",
        "__launch_bounds__(kGatherWarps * 32, 8)\n    dpyramid_gather_kernel",
        1)], "gg_mipmap_dpyramid"),
    "K5a items of 64": ([("kSlots = 128;", "kSlots = 64;", 1)],
                        "gg_mipmap_dpyramid"),
    "K5a items of 256": ([("kSlots = 128;", "kSlots = 256;", 1)],
                         "gg_mipmap_dpyramid"),
}


def build(name):
    """Build one variant's mipmap_sample.cu into a library; return its path,
    ptxas's register counts of its kernels and the SASS counts of K1's and
    K3's."""
    edits = (VARIANTS[name][0] if name in VARIANTS
             else K5A_VARIANTS[name][0])
    d = os.path.join(ROOT, re.sub(r"\W+", "_", name))
    shutil.copytree(_build.CSRC, d)
    path = os.path.join(d, "mipmap_sample.cu")
    files = {f: open(os.path.join(d, f)).read() for f in os.listdir(d)}
    for old, new, count in edits:
        if old is None:
            files["mipmap_sample.cu"] += new
            continue
        cs.check(sum(s.count(old) for s in files.values()) == count,
                 f"{name}: {old!r} not found")
        files = {f: s.replace(old, new) for f, s in files.items()}
    for f, s in files.items():
        open(os.path.join(d, f), "w").write(s)
    so = os.path.join(d, "lib.so")
    log = _build._nvcc_run(name, [*_build.NVCC_FLAGS, "-shared", "-o", so,
                                  path])
    regs = re.findall(r"Compiling entry function '\w*?(pyramid_fwd|"
                      r"pyramid_dcoords|dpyramid_gather|dpyramid_merge|"
                      r"bin|dpyramid_atomic)_kernel\w*'.*?Used (\d+) "
                      r"registers", log, re.S)
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


def pyramid_floats(shape):
    """Floats of one image's pyramid: level 0, then the coarse levels."""
    return (shape.channels * shape.size ** 2,
            sum(shape.texel() * s * s for s in shape.sides()[1:]))


def k5a_route(what, shape, grid, levels, dout, pm, card):
    """Device time of K5a's route from ``dout`` to (d/dlevel0, d/dcoarse)
    on these inputs, in its parts, beside the plain autograd, the backward
    of F.grid_sample to the stack as a volume, and the two bounds; the
    route's result held against the plain autograd."""
    # clones: a tensor made in inference mode cannot enter autograd
    grid, levels = grid.clone(), levels.clone()
    N, dev = grid.shape[0], grid.device
    D, C = shape.num_levels, shape.channels
    stack_shape = (N, D, C, shape.height, shape.width)
    l0_floats, coarse_floats = pyramid_floats(shape)
    level0 = torch.zeros(N, C, shape.size, shape.size, device=dev,
                         requires_grad=True)
    coarse = torch.zeros(N, coarse_floats, device=dev, requires_grad=True)
    plain_out = mm._sample_pyramid(mm.Pyramid(level0, coarse, shape), grid,
                                   levels, pm)
    ref = torch.autograd.grad(plain_out, (level0, coarse), dout,
                              retain_graph=True)
    plain_ms = cs.device_ms(lambda: torch.autograd.grad(
        plain_out, (level0, coarse), dout, retain_graph=True))
    volume = torch.zeros(N, C, D, shape.height, shape.width, device=dev,
                         requires_grad=True)
    lib_out = F.grid_sample(volume, cs.volume_grid(grid, levels, D),
                            padding_mode=pm, align_corners=False)
    lib_ms = cs.device_ms(lambda: torch.autograd.grad(
        lib_out, (volume,), dout[:, :, None], retain_graph=True))
    del volume, lib_out
    io = cs.nbytes(grid, levels, dout)
    ops = cs.sampler_ops("mipmap_sample_dpyramid", levels.numel(), C)
    old_b = cs.bound(io + 4 * math.prod(stack_shape), ops)
    new_b = cs.bound(io + 4 * N * (l0_floats + coarse_floats), ops)
    # the route: MipmapSample.backward, which a tree's autograd runs for an
    # image that needs a gradient (K1's forward runs once, outside)
    out = mm.MipmapSample.apply(level0, coarse, shape, grid, levels, pm)

    def route():
        return torch.autograd.grad(out, (level0, coarse), dout,
                                   retain_graph=True)
    if hasattr(mm, "mipmap_sample_dpyramid"):
        parts = {k: cs.device_ms(route, name=k, per_call=1)
                 for k in cs.K5A_KERNEL_NAMES}
    else:  # a d/dstack scattered by one kernel, mapped by torch ops
        fill_ms, adjoint_ms = cs.parent_route_ms(shape, N, dev)
        parts = {"zero fill": fill_ms,
                 "scatter": cs.device_ms(route, name="mipmap", per_call=1),
                 "rebuild adjoint": adjoint_ms}
    route_ms = cs.device_ms(route)
    ours = route()
    err = max(cs.scaled_err(o, r) for o, r in zip(ours, ref))
    cs.check(err[1] <= cs.KERNEL_TOL, f"K5a's route on {what}: off by {err}")
    print(f"K5a route on {what}: pyramid {tuple(level0.shape)} + "
          f"{tuple(coarse.shape)}, grid {tuple(grid.shape)}, levels "
          f"{float(levels.min()):.2f}-{float(levels.max()):.2f}, {pm}, "
          f"device time: route {route_ms:.4f} ms ("
          + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
          + f"), plain autograd {plain_ms:.4f} ms, backward of F.grid_sample "
          f"to the volume (d/dstack only) {lib_ms:.4f} ms; bound writing the "
          f"stack {old_b[0]:.4f} ms ({old_b[1]}), writing the pyramid's "
          f"gradient {new_b[0]:.4f} ms ({new_b[1]}); max abs err {err[0]:.3e}"
          f" [{card}]")
    return route_ms


def cases(dev):
    """K1's, K3's and K5a's inputs from served batch-40 and 128 flagship
    forwards (see the module's docstring)."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "stn.pt")
        cs.make_checkpoint(path)
        model, _ = load_stn(path, supersize=256, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    k1_cases, k3_cases, k5a_cases = [], [], []
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
            k5a_cases.append((f"the {head} head's grid over {tuple(img.shape)}",
                              pyr.shape, grid, lv, dout, "border"))
            k5a_cases.append((f"the {head} head's grid over {tuple(x.shape)}",
                              args[0].shape, grid, args[2], dout, args[3]))
    img = torch.rand(cs.TRAIN_BATCH, 3, 128, 128, device=dev, generator=g)
    shape = mm._build_pyramid(img, 4).shape
    for kind, s in cs.SKEWED.items():
        grid = cs.scaled_grid(cs.TRAIN_BATCH, 128, s, dev)
        lv = mm.jmax(mm.mipmap_levels(grid, 128, 128, 3.5), 0.0).contiguous()
        dout = torch.randn(cs.TRAIN_BATCH, 3, 128, 128, device=dev,
                           generator=g)
        k5a_cases.append((f"the {kind} grid over {tuple(img.shape)}", shape,
                          grid, lv, dout, "border"))
    return k1_cases, k3_cases, k5a_cases


def k1_k3_variants(built, k1_cases, k3_cases, dev, card):
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
        print(f"{name} (registers: K1 {regs.get('pyramid_fwd')}, K3 "
              f"{regs.get('pyramid_dcoords')}; SASS instructions: K1 "
              f"{sass.get('fwd')}, K3 {sass.get('dcoords')}), device ms: "
              f"{', '.join(res)} [{card}]")



def k5a_variants(built, k5a_cases, dev, card):
    """Each K5a variant on the route's inputs, held against the plain
    autograd and timed."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    stream = _build.stream_of(dev)
    for name, (so, regs, _) in built.items():
        lib = ctypes.CDLL(so)
        entry = K5A_VARIANTS[name][1]
        fn = getattr(lib, entry)
        atomic = entry.endswith("atomic")
        fn.argtypes = [ptr] * (5 if atomic else 6) + [i32] * 10 + [ptr]
        fn.restype = i32
        size = lib.gg_mipmap_dpyramid_scratch
        size.argtypes, size.restype = [i32] * 5, ctypes.c_longlong
        res = []
        for what, shape, grid, lv, dout, pm in k5a_cases:
            N, P = grid.shape[0], grid.shape[1] * grid.shape[2]
            coarse_floats = pyramid_floats(shape)[1]
            dl0 = torch.empty(N, shape.channels, shape.size, shape.size,
                              device=dev)
            dco = torch.empty(N, coarse_floats, device=dev)
            scratch = torch.empty(max(1, size(N, shape.num_levels,
                                              shape.channels, shape.size, P)),
                                  device=dev, dtype=torch.uint8)
            ptrs = [grid.data_ptr(), lv.data_ptr(), dout.data_ptr(),
                    dl0.data_ptr(), dco.data_ptr()]
            if not atomic:
                ptrs.append(scratch.data_ptr())

            def run():
                cs.check(fn(*ptrs, N, shape.num_levels, shape.channels,
                            shape.size, shape.height, shape.width, shape.lp,
                            P, _build.padding_code(pm), dev.index,
                            stream) == 0, f"{name}: K5a launch failed")
            run()
            out, ins, cot = cs.k5a_graph((shape, grid, lv, dout, pm))
            refs = torch.autograd.grad(out, ins, cot)
            err = max(cs.scaled_err(o, r)[1]
                      for o, r in zip((dl0, dco), refs))
            cs.check(err <= cs.KERNEL_TOL, f"{name}: {what} off by {err}")
            res.append(f"{what} {cs.device_ms(run, iters=50):.4f}")
        print(f"{name} (registers {regs}), device ms: {', '.join(res)} "
              f"[{card}]")

def main():
    if not ARGS.tree:
        shutil.rmtree(ROOT, ignore_errors=True)
        names = [*VARIANTS, *K5A_VARIANTS]
        with ThreadPoolExecutor(len(names)) as pool:
            built = dict(zip(names, pool.map(build, names)))
    dev, card = cs.setup()
    print(f"gangealing_torch from {os.path.dirname(gangealing_torch.__file__)}")
    k1_cases, k3_cases, k5a_cases = cases(dev)
    for what, *args in k5a_cases:
        k5a_route(what, *args, card)
    if ARGS.tree:
        return 0
    k1_k3_variants({k: built[k] for k in VARIANTS}, k1_cases, k3_cases,
                   dev, card)
    k5a_variants({k: built[k] for k in K5A_VARIANTS}, k5a_cases, dev, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
