"""Smoke run of gangealing_torch on one CUDA card: build the kernels, hold
them against their plain PyTorch versions, serve the flagship ComposedSTN
congeal forward through them, train the flagship GANgealing configuration
through them, and run the AR object-lens app through them.

    python3 chip_smoke.py

Phases:
  1. setup: build or load the kernels from gangealing_torch/csrc, print the
     card (nvidia-smi name and power limit) and torch version, switch TF32 off;
  2. each kernel against its plain version at the flagship shapes (N=8, C=3,
     256x256 source, 128x128 output) in the three padding modes, atol 1e-5;
  3. the flagship ComposedSTN (similarity then flow, flow_size 128, 256px
     input, channel_multiplier 0.5, iters 1, border padding) with seeded
     random weights, saved in the reference checkpoint schema and loaded back
     through apps/common.load_stn; congeal requests with their flow scores
     at batch 40 and 128 (a timed window of about 5 s each, CUDA events),
     one antialias=False forward, and the kernel launch counts of that run;
     then each kernel launch of a served forward held against its plain
     version on the inputs the forward gave it (K1 at batch 40 and 128, K2
     at 40); K1 timed on those inputs beside its plain version,
     and K2 on those of each antialias=False head beside its plain version,
     F.grid_sample and its bound,
     F.grid_sample on the full-resolution volume and its bound on the
     pyramid, and the whole mipmap warp's device time (levels, pyramid,
     K1) on the same inputs; K5a on each batch-40 head's grid and levels
     over the 256 px source, its three kernels apart, beside its plain
     autograd, F.grid_sample's backward to the volume, its bound and the
     bound that writes the full-resolution stack, and the torch parts of
     the parent commit's route (the stack's zero fill and the rebuild's
     adjoint); batch-4 forwards with and without
     anti-aliasing held against the port's CPU path (out 5e-4, grid and
     flow 1e-4), and the device time of a few forwards by kernel group
     with the idle share;
  4. training, the reference's LSUN-cats run (scripts/training/
     lsun_cats_ssl.sh: 256px StyleGAN2 with 512-dim latents and 8 mapping
     layers, the flagship STN, vgg_ssl, tv_weight 1000, border padding,
     batch 40) with seeded random G and VGG: python -m
     gangealing_torch.cli.train for 4 iterations (1M-latent PCA cold
     start, checkpoints at 2 and 4, scalars finite, the last checkpoint
     resumed), K1 and K3 twice per step and K5a never; the perceptual term
     alone reaching the identity-initialised similarity head; each K1 and
     K3 launch of a step from the trained state and of one from the
     identity init, K3 again on the first with every level a float step
     below an integer, each K2 and K4 launch of an antialias=False step and
     each K5a and K5b launch of a forward whose input needs a gradient held
     against the plain versions and their autograd (1e-5 scaled by
     max(1, max|ref|)); K5a and K5b on that forward's d/dout with the
     identity grid, a recorded one, a zoom-in and a border pile in the
     three padding modes, held the same way and run three times, equal to
     the bit, the skewed ones timed; K5a timed on each recorded launch and
     on the skewed grids as in phase 3; train imgs/s over about 5 s and the peak
     memory of a step; the device time of each head's mipmap warp and its backward to
     the grid; the device time of a step by kernel group with the idle
     share; and one step's loss and gradients on the card against the
     port's CPU path at batch 2, from the trained state and from the
     identity init (TRAIN_GRAD_TOL, TRAIN_GRAD_L2_TOL);
  5. the AR object lenses (apps/mixed_reality.run_gangealing_on_video)
     with the flagship STN loaded through load_stn and a synthetic dense
     label (an opaque disc of radius 36 px in the 128 px congealed space,
     smoothly varying colours, passed as points, colors and alphas): 256px
     smooth frames at the eval batch of 50, sigma 1.2, opacity 1, flip
     inference on, alpha blending; a warm-up batch, the peak memory of a
     batch, AR frames/s over about 5 s in parts, one batch with every K1,
     K2 and K6 launch held against its plain version on the inputs it got,
     that batch's K2 reading gridB's own storage (no copy) and timed on
     its inputs beside its plain version, F.grid_sample on the same view,
     its bound and the copy it no longer makes,
     one with the Laplacian blend and the label overlaid on the congealed
     frames, one batch of apps/propagate_to_images (objects=True, the label
     read from an RGBA PNG) with its launches held the same way, and
     python -m gangealing_torch.cli.mixed_reality in process on a directory
     of PNG frames; K1 6, K2 1 and K6 1 (the object and the mask in one
     launch) a batch, 1 more with the overlay; then 2 frames of each app on
     the card against the port's CPU path (points 0.05 px, congealed frames
     5e-4, equal flips, propagated frames within 1e-3 in mean absolute
     error); models/stn.composed_propagate_object at batch 50 (one K6) and
     the path's splat with a quarter of its points hidden at -1e6, each K6
     launch held against the plain splat; K6 on a toy pair, as the general
     splat2d_cuda on a canvas, and on the path's points at sigma 4 (its
     shared list overflows) held the same way, and the path's splat run
     twice more, equal to the bit; the pair's device time at the path's
     shapes beside the two splat2d_cuda launches it replaces, its plain
     version, its bound and torch.bmm of the TPU kernel's separable
     formulation; the pair on a dense 256^2 label over 8 images of 1024 px,
     held and timed (no gate); and the device time of a batch by kernel
     group with the idle share;
  6. rates, and each kernel's device time (torch.profiler; K6's by CUDA
     events around back-to-back calls, as a profile of it now and then
     misses launches) beside its plain version's, its bound on the card (the bytes of an image that
     these grids must read counted as the distinct texels their taps reach;
     for K1 and K3 those of the native-resolution pyramid that their
     rebuilt taps reach) and the time of the PyTorch call that computes the
     same function where there is one (F.grid_sample, on the full-resolution
     stack as a volume for the mipmap kernels; torch.bmm of the separable
     weights for K6), each beside the card; K1's
     figures are those of a served batch-128 forward, per launch, K2's
     those of an AR batch, K5a's and K5b's those of the train phase's
     check (three kernels a call each), and the
     N=8 ones a toy-size line apart; the kernels line, whose
     "launches" are the main path's (serve, cli.train and the AR apps) and
     whose "check_launches" are the side checks' (the antialias=False step,
     the forward whose input needs a gradient and the
     composed_propagate_object check).

Any failure raises and the exit code is not 0. The last line of standard
output is the JSON result {"ok": true, "device": {...}}.
"""

import argparse
import contextlib
import copy
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from gangealing_torch import LAUNCHES, _build
from gangealing_torch.apps.common import determine_flips, load_stn
from gangealing_torch.apps.mixed_reality import run_gangealing_on_video
from gangealing_torch.apps.propagate_to_images import propagate_to_images
from gangealing_torch.cli import mixed_reality as mixed_reality_cli
from gangealing_torch.cli import train as train_cli
from gangealing_torch.models.latent_learner import LatentLearner
from gangealing_torch.models.lpips import make_perceptual_loss
from gangealing_torch.models import stn as stn_ops
from gangealing_torch.models.stn import (
    ComposedSTN, ComposedSTNConfig, composed_propagate_object,
    normalize_points)
from gangealing_torch.models.stylegan2 import Generator, GeneratorConfig
from gangealing_torch.ops import grid_sample as grid_sample_ops
from gangealing_torch.ops import mipmap as mipmap_ops
from gangealing_torch.ops import splat as splat_ops
from gangealing_torch.ops.flow import total_variation_loss
from gangealing_torch.ops.grid_sample import (
    affine_grid, grid_sample, grid_sample_auto, grid_sample_cuda)
from gangealing_torch.ops.mipmap import (
    _build_pyramid, _mipmap_warp_fold, _rebuild_stack, _sample_pyramid,
    mipmap_levels, mipmap_sample, mipmap_warp)
from gangealing_torch.ops.resample import interpolate_bilinear
from gangealing_torch.ops.splat import splat2d, splat2d_pair
from gangealing_torch.train import checkpoint as train_ckpt
from gangealing_torch.train.losses import gangealing_loss
from gangealing_torch.train.state import TrainState, train_step

PADDINGS = ("border", "reflection", "zeros")
KERNEL_TOL = 1e-5
# F.grid_sample on the stack as a volume against K1, and torch.bmm of the
# separable weights against K6: the same function, its weights formed and
# summed in another order
LIBRARY_TOL = 1e-4
OUT_TOL, GRID_TOL = 5e-4, 1e-4
FLAGSHIP = ComposedSTNConfig(transforms=("similarity", "flow"), flow_size=128,
                             supersize=256, channel_multiplier=0.5)
FLAGSHIP_ARGS = dict(transform=["similarity", "flow"], flow_size=128,
                     stn_channel_multiplier=0.5, num_heads=1, real_size=256)
BATCHES = (40, 128)
REQUESTS = 5  # distinct request batches per batch size
# Requests in the timed window of each batch size (about 5 s each on an
# H100 at 700 W), served in SUBWINDOWS equal parts cycling the REQUESTS.
TIMED = {40: 64, 128: 32}
SUBWINDOWS = 4
PROFILED = 3  # forwards per batch size under torch.profiler
TRAIN_BATCH = 40
TRAIN_ITERS = 4
# Train steps in the timed window (about 5.6 s on an H100 at 700 W, 0.7 s a
# step), in SUBWINDOWS equal parts after 2 warm-up steps.
TRAIN_TIMED = 8
# One step's loss terms and gradients, card against the port's CPU path at
# batch 2, from the trained state and from the identity init: loss terms
# within 1e-4 relative; each gradient tensor within TRAIN_GRAD_TOL of its
# largest CPU value, and all of them together, as one vector, within
# TRAIN_GRAD_L2_TOL in relative L2 norm. The loss is piecewise smooth (ReLUs,
# max-pools, floors, maxima); a unit within float32 rounding of a kink takes
# one side on one device and the other on the other, and one flipped unit
# moves a gradient by about 1e-3 of its size (tests/test_torch_train_grads.py
# measured up to 1.4e-3 against JAX on the CPU). Tensors whose gradient is a
# sum with much cancellation, such as the biases of the flow head's mask
# conv (a softmax's logits), read several times that: the worst tensor read
# up to 4.870e-3 from the trained state on an H100 at 700 W, so the tensor
# gate only catches gross faults. The L2 gate is the tight one: it read
# 1.1e-4 to 1.3e-4 there, and sits well below what the plain samplers' old
# tie rules do to the gradients at the identity init (PERF.md).
TRAIN_GRAD_TOL = 2e-2
TRAIN_GRAD_L2_TOL = 1e-3
KERNEL_INFO = {  # name: (source, the TPU kernel it replaces)
    "mipmap_sample": ("gangealing_torch/csrc/mipmap_sample.cu",
                      "gangealing_tpu/ops/pallas_mipmap.py:84"),
    "grid_sample": ("gangealing_torch/csrc/grid_sample.cu",
                    "gangealing_tpu/ops/pallas_grid_sample.py:41"),
    "mipmap_sample_dcoords": ("gangealing_torch/csrc/mipmap_sample.cu",
                              "gangealing_tpu/ops/pallas_mipmap.py:131"),
    "grid_sample_dgrid": ("gangealing_torch/csrc/grid_sample.cu",
                          "gangealing_tpu/ops/pallas_grid_sample.py:91"),
    "mipmap_sample_dpyramid": ("gangealing_torch/csrc/mipmap_sample.cu",
                               "gangealing_tpu/ops/pallas_mipmap.py:105"),
    "grid_sample_dimg": ("gangealing_torch/csrc/grid_sample.cu",
                         "gangealing_tpu/ops/pallas_grid_sample.py:64"),
    "splat": ("gangealing_torch/csrc/splat.cu",
              "gangealing_tpu/ops/splat.py:106"),
}
# The AR phase: the eval CLI's default batch, the app's default sigma,
# frames of the timed window (AR_BATCH each, run SUBWINDOWS times: about
# 5 s on an H100 at 700 W), a synthetic label's disc in the 128 px
# congealed space.
AR_BATCH = 50
AR_SIGMA = 1.2
AR_FRAMES = 200
LABEL_RADIUS = 36
AR_PT_TOL, AR_PROP_MEAN_TOL = 0.05, 1e-3
# Published peaks of one H100 SXM (NVIDIA's data sheet): HBM3 bytes/s and
# float32 operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


# K5b's kernels a call: bin, gather, merge.
K5B_KERNELS = 3
# K5a's kernels, by a part of their names: bin, gather, merge.
K5A_KERNEL_NAMES = ("bin_kernel", "dpyramid_gather", "dpyramid_merge")
# K5b's skewed grids: a zoom-in by 4 (every point in a sixteenth of the
# image) and a zoom-out by 2 (three quarters of the points clamped onto the
# edge texels under border padding).
SKEWED = {"zoom-in": 0.25, "border pile": 2.0}


# The kernels the main path launches: K1 and K2 in serve (K2 in its
# antialias=False forward), K1 and K3 in every train step, K1, K2 and K6 in
# every batch of the AR app.
MAIN_PATH_KERNELS = ("mipmap_sample", "grid_sample", "mipmap_sample_dcoords",
                     "splat")


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def call_ms(fn, iters=20, warmup=3):
    """Time per call of ``fn`` in ms, from CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls. For a call shorter than its
    host-side launch path this measures the host, not the kernel."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# torch.profiler's windows: windows taken for one profile before the
# smoke gives up; the launches of torch.cuda._sleep that open each window
# (its kernel's name), the last of them spinning for SPIN_CYCLES, about
# 20 ms at the H100's 1.98 GHz; idle seconds after the profiled work.
PROFILE_TRIES = 5
SENTINELS = 256
SENTINEL = "spin_kernel"
# the range around the profiled work, which the tracer also shows as an
# event on the card
RUN_RANGE = "profiled run"
SPIN_CYCLES = 40_000_000
PROFILE_PAD_S = 0.02
# windows taken, and those taken again because they missed a kernel
WINDOWS = {"taken": 0, "retaken": 0}


def profiled(run, accept=None):
    """torch.profiler (CPU and CUDA activity) over ``run()``. The tracer
    on an H100 loses kernels in two ways. Once a process has opened a few
    windows, the first launches of a window have no kernel event (the
    first in 35 of 61 windows of one smoke, the first three later on),
    sometimes no host-side event either. And now and then it stamps
    kernels milliseconds before their host-side launch and drops those
    that this places before the window's start (one whole window, one
    first 11 of 20 kernels, in 240 windows; none in 240 that began with
    20 ms of idle time). So a window opens with SENTINELS launches of
    torch.cuda._sleep, which nothing counts, the last of which keeps the
    card busy for about 20 ms while ``run()`` launches behind it. A
    window in which a launch made by ``run()`` has no kernel event is
    taken again, as is one for which ``accept(profile)`` returns a
    reason, up to PROFILE_TRIES windows; then the smoke fails. Returns
    the profile."""
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    short = []
    for _ in range(PROFILE_TRIES):
        WINDOWS["taken"] += 1
        with torch.profiler.profile(activities=activities) as prof:
            for _ in range(SENTINELS - 1):
                torch.cuda._sleep(1)
            torch.cuda._sleep(SPIN_CYCLES)
            with torch.profiler.record_function(RUN_RANGE):
                run()
                torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
        events = prof.profiler.kineto_results.events()
        span = next(((e.start_ns(), e.end_ns()) for e in events
                     if e.name() == RUN_RANGE
                     and e.device_type() != torch.autograd.DeviceType.CUDA),
                    (1, 0))
        kernels = {e.correlation_id() for e in events
                   if e.device_type() == torch.autograd.DeviceType.CUDA}
        launches = sorted((e.start_ns(), e.correlation_id()) for e in events
                          if e.device_type() != torch.autograd.DeviceType.CUDA
                          and "LaunchKernel" in e.name()
                          and span[0] <= e.start_ns() <= span[1])
        missed = [i for i, (_, c) in enumerate(launches) if c not in kernels]
        if launches and not missed:
            why = accept(prof) if accept else None
            if why is None:
                return prof
        else:
            why = (f"kernels of {len(launches) - len(missed)} of "
                   f"{len(launches)} launches, lost the launches {missed[:4]}")
        WINDOWS["retaken"] += 1
        short.append(why)
    raise AssertionError(f"no good profile in {PROFILE_TRIES} windows: "
                         f"{'; '.join(short)}")


def device_ms(fn, iters=20, name=None, per_call=None):
    """Device time per call of ``fn`` in ms: the summed time of the kernels
    (and copies) one call launches, those whose name holds ``name`` if it
    is given, from a ``profiled`` window over ``iters`` calls after one
    call outside it. The window saw every kernel launched in it, and is
    taken again unless the kernels timed number a whole count a call,
    ``per_call`` where it is given."""
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(iters):
            fn()

    def timed(prof):
        return [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and SENTINEL not in e.key and e.key != RUN_RANGE
                and (name is None or name in e.key)]

    def accept(prof):
        events = timed(prof)
        count = sum(e.count for e in events)
        if count > 0 and count % iters == 0 and (
                per_call is None or count == per_call * iters):
            return None
        return (f"{count} kernels{f' named {name}' if name else ''} for "
                f"{iters} calls, expected {per_call or 'a whole count'} a "
                f"call: " + ", ".join(f"{e.count} {e.key[:60]}"
                                      for e in events[:6]))
    events = timed(profiled(run, accept))
    return sum(e.self_device_time_total for e in events) / 1e3 / iters


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def setup():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is visible")
    t0 = time.perf_counter()
    _build.load_kernels()
    lib = _build.library_path()
    print(f"kernels: {lib.name} built or loaded in "
          f"{time.perf_counter() - t0:.2f} s")
    log = lib.with_suffix(".log")
    if log.exists():
        steps = []
        for line in log.read_text().splitlines():
            if line.startswith("== nvcc"):
                steps.append(float(line.split()[-2]))
            if "registers" in line or "spill" in line or \
                    line.startswith("== nvcc"):
                print(f"  {line.strip()}")
        if len(steps) > 1:
            print(f"  cold build: the compiles took {sum(steps[:-1]):.2f} s "
                  f"summed, {max(steps[:-1]):.2f} s the longest; the link "
                  f"{steps[-1]:.2f} s")
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0), card


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(moved, ops):
    """The least time (ms) the card could take for a function that moves
    ``moved`` bytes between memory and the chip and does ``ops`` float32
    operations, and which of the two bounds it: bytes over the HBM rate or
    operations over the f32 rate."""
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def texel_bytes(image, grid, levels=None, padding_mode="border"):
    """Bytes of ``image`` (N, C, H, W), or of a stack (N, D, C, H, W)
    sampled at per-point ``levels``, that a bilinear sample at ``grid``
    (N, Ho, Wo, 2), align_corners=False, must read: each distinct texel
    that a point's taps reach with a nonzero weight (on its floor and ceil
    levels for a stack), C float32 values each. Border padding clamps the
    taps into the image; zeros padding drops those outside it."""
    check(padding_mode in ("border", "zeros"), f"texel_bytes: {padding_mode}")
    N, C, H, W = image.shape[0], *image.shape[-3:]
    D = image.shape[1] if image.ndim == 5 else 1
    ix = ((grid[..., 0] + 1) * W - 1) / 2
    iy = ((grid[..., 1] + 1) * H - 1) / 2
    if padding_mode == "border":
        ix, iy = ix.clamp(0, W - 1), iy.clamp(0, H - 1)
    ls = (torch.zeros_like(ix),) if levels is None else \
        (levels.floor(), levels.ceil())
    n = torch.arange(N, device=grid.device).view(N, 1, 1)
    keys = []
    for lv in ls:
        for y in (iy.floor(), iy.ceil()):
            for x in (ix.floor(), ix.ceil()):
                inside = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
                key = ((n * D + lv.long()) * H + y.long()) * W + x.long()
                keys.append(key[inside])
    return torch.unique(torch.cat(keys)).numel() * C * image.element_size()


def pyramid_texel_bytes(image_shape, grid, levels, padding_mode="border",
                        dcoords=False):
    """Bytes of a native-resolution Gaussian pyramid of an image of
    ``image_shape`` (N, C, H, W) that a mipmap sample at ``grid`` and
    ``levels`` must read: each full-resolution tap that a point reaches with
    a nonzero weight, on its floor and ceil levels (with ``dcoords`` also on
    the levels next to an integer level, whose tent has a slope there),
    rebuilt from the distinct texels of its native (Hp/2^d, Wp/2^d) level
    that interpolate_bilinear weighs with a nonzero weight (on level 0 the
    tap itself). Hp, Wp: the size reflect-padded to a power of 2, as the
    pyramid stores it. C float32 values each."""
    check(padding_mode in ("border", "zeros"), f"texels: {padding_mode}")
    N, C, H, W = image_shape
    size = 2 ** math.ceil(math.log2(W))
    lp = (size - W) // 2
    D = 4
    ix = ((grid[..., 0] + 1) * W - 1) / 2
    iy = ((grid[..., 1] + 1) * H - 1) / 2
    if padding_mode == "border":
        ix, iy = ix.clamp(0, W - 1), iy.clamp(0, H - 1)
    f = levels.floor()
    ls = [f, levels.ceil()]
    if dcoords:
        # the level tent's kinks: f - 1 and f + 1 at an integer level, and
        # f + 2 where |level - (f + 2)| rounds to 1
        whole = levels == f
        kink = levels - (f + 2) == -1
        ls += [torch.where(whole, levels - 1, f).clamp(min=0),
               torch.where(whole, levels + 1, f).clamp(max=D - 1),
               torch.where(kink, f + 2, f).clamp(max=D - 1)]
    n = torch.arange(N, device=grid.device).view(N, 1, 1)

    def coarse(i, d):
        """The coarse indices a full-resolution index i of level d reads
        with a nonzero weight: r0 always, r1 where its weight is not 0."""
        hc = size // 2 ** d
        src = ((i + lp + 0.5) * 2.0 ** -d - 0.5).clamp(min=0)
        src = torch.minimum(src, hc - 1.0)
        r0 = src.floor()
        r1 = torch.minimum(r0 + 1, hc - 1.0)
        return ((r0, torch.ones_like(r0, dtype=torch.bool)),
                (r1, src > r0))

    keys = []
    for lv in ls:
        d = lv.long()
        for y in (iy.floor(), iy.ceil()):
            for x in (ix.floor(), ix.ceil()):
                inside = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
                for r, rw in coarse(y.clamp(0, H - 1), d):
                    for c, cw in coarse(x.clamp(0, W - 1), d):
                        key = (((n * D + d) * size + r.long()) * size
                               + c.long())
                        keys.append(key[inside & rw & cw])
    return torch.unique(torch.cat(keys)).numel() * C * 4


def image_shape(pyramid):
    """(N, C, H, W) of the image a pyramid was built from."""
    shape = pyramid.shape
    return (pyramid.level0.shape[0], shape.channels, shape.height,
            shape.width)


def as_volume(stack):
    """A stack (N, D, C, H, W) as F.grid_sample's volume (N, C, D, H, W)."""
    return stack.permute(0, 2, 1, 3, 4).contiguous()


def volume_grid(grid, levels, D):
    """The grid (N, Ho, Wo, 2) with the levels as its depth coordinate,
    (N, 1, Ho, Wo, 3). With align_corners=False depth d sits at
    z = (2d + 1) / D - 1, and trilinear sampling of the volume is K1's
    bilinear sample times its level tent; the levels lie in [0, D - 1],
    where no padding mode acts along the depth."""
    z = (2 * levels + 1) / D - 1
    return torch.cat([grid, z[..., None]], -1)[:, None].contiguous()


# Operations per output point (grid point) of each sampler, counted as
# the multiplies and adds of its taps per channel plus about 20 (40 for a
# backward) for the point's coordinates, weights and padding rule.
def sampler_ops(name, points, C):
    per_channel = {"mipmap_sample": 2 * 4 * 2 + 3, "grid_sample": 4 * 2,
                   "mipmap_sample_dcoords": 2 * 4 * 4,
                   "grid_sample_dgrid": 4 * 4,
                   "mipmap_sample_dpyramid": 2 * 9 * 2,
                   "grid_sample_dimg": 4 * 2}[name]
    per_point = 40 if name.endswith(("dcoords", "dgrid", "dpyramid")) \
        else 20
    return points * (C * per_channel + per_point)


def splat_bound(coords, sigma, reads, outs):
    """Bound of a splat on these inputs: the points, sigma and ``reads``
    (the value sets, and the canvas where there is one) read once and
    ``outs`` written once; operations per pixel of each visible point's
    own window (2 exps, the weight, a multiply-add for each channel of
    every output and the alpha add: the weight is counted once however
    many outputs share it), and the normalisation's 2 per output value."""
    N, _, H, W = outs[0].shape
    C = sum(o.shape[1] for o in outs)
    x, y = coords[..., 0], coords[..., 1]
    s = 2.0 * sigma[:, None]
    rows = (torch.clamp(torch.ceil(y + s), max=H - 1)
            - torch.clamp(torch.floor(y - s), min=0) + 1)
    cols = (torch.clamp(torch.ceil(x + s), max=W - 1)
            - torch.clamp(torch.floor(x - s), min=0) + 1)
    visible = (x >= 0) & (x < W) & (y >= 0) & (y < H)
    pixels = float((rows * cols * visible).sum())
    ops = pixels * (2 * C + 6) + 2 * sum(o.numel() for o in outs)
    return bound(nbytes(coords, sigma, *reads, *outs), ops)


def kernel_inputs(dev):
    """Flagship-shaped inputs: per image a similarity from a zoom-in by 0.3
    to a zoom-out by 4, with rotation and shift, plus a random smooth flow,
    so that the levels span [0, 2.5] and some points leave the image."""
    g = torch.Generator().manual_seed(0)
    N = 8
    img = torch.randn(N, 3, 256, 256, generator=g)
    s = torch.logspace(-0.52, 0.6, N)  # 0.3 ... 4
    a = (torch.rand(N, generator=g) * 2 - 1) * 3.14159
    t = (torch.rand(N, 2, generator=g) * 2 - 1) * 0.3
    theta = torch.stack([
        torch.stack([s * a.cos(), -s * a.sin(), t[:, 0]], 1),
        torch.stack([s * a.sin(), s * a.cos(), t[:, 1]], 1)], 1)
    flow = interpolate_bilinear(0.02 * torch.randn(N, 2, 16, 16, generator=g),
                                128, 128).permute(0, 2, 3, 1)
    grid = (affine_grid(theta, (N, 3, 128, 128)) + flow).contiguous()
    img, grid = img.to(dev), grid.to(dev)
    levels = mipmap_levels(grid, 256, 256, 3.5).contiguous()
    check(float(levels.min()) == 0.0 and float(levels.max()) == 2.5,
          "kernel inputs: levels do not span [0, 2.5]")
    check(bool((grid.abs() > 1).any()), "kernel inputs: no point leaves the image")
    return img, grid, levels


def kernels_vs_plain(dev):
    img, grid, levels = kernel_inputs(dev)
    pyramid = _build_pyramid(img, 4)
    errs = {"mipmap_sample": 0.0, "grid_sample": 0.0}
    for pm in PADDINGS:
        e1 = float((mipmap_warp(img, grid, padding_mode=pm)
                    - _mipmap_warp_fold(img, grid, 4, levels, pm)).abs().max())
        e2 = float((grid_sample_auto(img, grid, padding_mode=pm)
                    - grid_sample(img, grid, padding_mode=pm)).abs().max())
        print(f"K1 mipmap_sample vs _mipmap_warp_fold [{pm}]: "
              f"max abs err {e1:.3e}")
        print(f"K2 grid_sample vs plain grid_sample [{pm}]: "
              f"max abs err {e2:.3e}")
        check(e1 <= KERNEL_TOL, f"K1 disagrees with its plain version ({pm})")
        check(e2 <= KERNEL_TOL, f"K2 disagrees with its plain version ({pm})")
        errs["mipmap_sample"] = max(errs["mipmap_sample"], e1)
        errs["grid_sample"] = max(errs["grid_sample"], e2)
    calls = {
        "mipmap_sample": (lambda: mipmap_sample(pyramid, grid, levels),
                          lambda: _sample_pyramid(pyramid, grid, levels,
                                                  "border")),
        "grid_sample": (lambda: grid_sample_cuda(img, grid),
                        lambda: grid_sample(img, grid)),
    }
    # device time of the kernel(s) and time per call, kernel then plain
    times = {name: (device_ms(k), device_ms(p), call_ms(k), call_ms(p))
             for name, (k, p) in calls.items()}
    N, C, Ho, Wo = mipmap_sample(pyramid, grid, levels).shape
    out = torch.empty(N, C, Ho, Wo, device=dev)
    # the bytes each must read: the taps these grids and levels reach
    bounds = {
        "mipmap_sample": bound(
            pyramid_texel_bytes(img.shape, grid, levels)
            + nbytes(grid, levels, out),
            sampler_ops("mipmap_sample", N * Ho * Wo, C)),
        "grid_sample": bound(texel_bytes(img, grid) + nbytes(grid, out),
                             sampler_ops("grid_sample", N * Ho * Wo, C)),
    }
    # the PyTorch call that computes K2's function, in each padding mode
    library = {pm: device_ms(lambda: F.grid_sample(
        img, grid, mode="bilinear", padding_mode=pm, align_corners=False))
        for pm in PADDINGS}
    print("F.grid_sample at N=8 C=3 256->128, device time: " + ", ".join(
        f"{pm} {ms:.4f} ms" for pm, ms in library.items()))
    # and K1's: F.grid_sample on the full-resolution stack as a volume,
    # trilinear
    volume = as_volume(_rebuild_stack(pyramid))
    grid3 = volume_grid(grid, levels, pyramid.shape.num_levels)

    def k1_library():
        return F.grid_sample(volume, grid3, mode="bilinear",
                             padding_mode="border", align_corners=False)

    e = float((k1_library()[:, :, 0]
               - mipmap_sample(pyramid, grid, levels))
              .abs().max())
    k1_ms = device_ms(k1_library)
    print(f"F.grid_sample on the stack as a volume (N, C, D, H, W) "
          f"{tuple(volume.shape)} at N=8 256->128: max abs err vs K1 "
          f"{e:.3e}, device time {k1_ms:.4f} ms")
    check(e <= LIBRARY_TOL, "F.grid_sample on the volume is not K1's function")
    return errs, times, bounds, {"grid_sample": library["border"],
                                 "mipmap_sample": k1_ms}


def make_checkpoint(path):
    """The flagship STN with the port's own seeded init, every parameter
    perturbed by 0.05 noise so that neither head is an identity warp, saved
    in the reference schema."""
    g = torch.Generator().manual_seed(0)
    model = ComposedSTN(FLAGSHIP, generator=g)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    torch.save({"t_ema": model.state_dict(),
                "args": argparse.Namespace(**FLAGSHIP_ARGS)}, path)


def congeal(model, imgs):
    """One congeal request: the aligned images, grids, residual flows and
    the per-image flow scores of the serving apps."""
    with torch.inference_mode():
        out, grid, flow, _, _ = model(imgs, iters=1, padding_mode="border")
        scores = -total_variation_loss(flow, reduce_batch=False)
    return out, grid, flow, scores


def check_outputs(result, n):
    out, grid, flow, scores = result
    check(tuple(out.shape) == (n, 3, 128, 128), f"out shape {tuple(out.shape)}")
    check(tuple(grid.shape) == (n, 128, 128, 2), f"grid shape {tuple(grid.shape)}")
    check(tuple(flow.shape) == (n, 128, 128, 2), f"flow shape {tuple(flow.shape)}")
    check(tuple(scores.shape) == (n,), f"scores shape {tuple(scores.shape)}")
    for name, t in zip(("out", "grid", "flow", "scores"), result):
        check(bool(torch.isfinite(t).all()), f"{name} is not finite")


@contextlib.contextmanager
def recorded(module, name):
    """Record the arguments and result of every call of ``module.name``
    made inside the block (the wrappers call their kernel entry points by
    module-level name)."""
    fn = getattr(module, name)
    calls = []

    def record(*args, **kw):
        out = fn(*args, **kw)
        calls.append((args + tuple(kw.values()), out))
        return out

    setattr(module, name, record)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def kernels_at_path_shapes(model, no_aa, requests):
    """Each kernel launch of one served forward against its plain version on
    the very inputs the forward gave it: K1 in both heads at batch 40 and
    128, K2 in both heads of the antialias=False forward at batch 40.
    Returns the errors, and K1's recorded launches and the mipmap warps'
    inputs by batch size."""
    def plain_k2(img, grid, padding_mode):
        return grid_sample(img, grid, padding_mode=padding_mode)

    cases = [("mipmap_sample", mipmap_ops, "mipmap_sample", _sample_pyramid,
              model, b) for b in BATCHES]
    cases.append(("grid_sample", grid_sample_ops, "grid_sample_cuda",
                  plain_k2, no_aa, 40))
    err = {"mipmap_sample": 0.0, "grid_sample": 0.0}
    k1_calls, warps, k2_calls = {}, {}, []
    for name, module, entry, plain, m, b in cases:
        with recorded(module, entry) as calls, \
                recorded(stn_ops, "mipmap_warp") as warp_calls:
            check_outputs(congeal(m, requests[b][0]), b)
        check(len(calls) == 2, f"{name}: {len(calls)} launches in one "
              "forward, expected 2")
        if name == "mipmap_sample":
            k1_calls[b], warps[b] = calls, [a for a, _ in warp_calls]
        else:
            k2_calls = calls
        for head, (args, out) in zip(("similarity", "flow"), calls):
            with torch.inference_mode():
                e = float((out - plain(*args)).abs().max())
            shapes = " ".join(str(tuple(a.shape)) for a in args
                              if torch.is_tensor(a))
            print(f"{name} in the {head} head at batch {b}, inputs {shapes}: "
                  f"max abs err vs plain {e:.3e}")
            check(e <= KERNEL_TOL, f"{name} disagrees with its plain version "
                  f"in the {head} head at batch {b}")
            err[name] = max(err[name], e)
    return err, k1_calls, warps, k2_calls


def k2_times(img, grid, padding_mode="border"):
    """K2 on these inputs as grid_sample_auto takes them: the device time
    of K2's kernel and of the whole call (with any copy of the input that
    it makes), of the plain version, of F.grid_sample on the input in the
    same layout, and K2's bound. Returns (ms, plain_ms, bound_ms, bound_by,
    library_ms, call_ms)."""
    with torch.inference_mode():
        def k2():
            return grid_sample_auto(img, grid, padding_mode=padding_mode)
        out = k2()
        ms = device_ms(k2, name="grid_sample_kernel", per_call=1)
        call = device_ms(k2)
        plain_ms = device_ms(lambda: grid_sample(img, grid,
                                                 padding_mode=padding_mode))
        lib_ms = device_ms(lambda: F.grid_sample(
            img, grid, mode="bilinear", padding_mode=padding_mode,
            align_corners=False))
        b = bound(texel_bytes(img, grid, padding_mode=padding_mode)
                  + nbytes(grid, out),
                  sampler_ops("grid_sample", grid.numel() // 2, img.shape[1]))
    return (ms, plain_ms, *b, lib_ms, call)


def print_k2(what, img, grid, t, card):
    print(f"K2 {what}, input {tuple(img.shape)} (strides {img.stride()}), "
          f"grid {tuple(grid.shape)}, device time: kernel {t[0]:.4f} ms "
          f"(grid_sample_auto {t[5]:.4f} ms), plain {t[1]:.4f} ms, "
          f"F.grid_sample {t[4]:.4f} ms; bound {t[2]:.4f} ms ({t[3]}) "
          f"[{card}]")


def k5b_times(grid, dout, shape, padding_mode="border",
              per_call=K5B_KERNELS):
    """K5b on these inputs: the device time of its kernels (``per_call``
    a call), of the plain autograd and of F.grid_sample's backward to the
    image, and its bound (grid and dout read, d/dimage written once).
    Returns (ms, plain_ms, bound_ms, bound_by, library_ms)."""
    x = torch.zeros(shape, device=grid.device, requires_grad=True)
    plain_out = grid_sample(x, grid, padding_mode=padding_mode)
    lib_out = F.grid_sample(x, grid, padding_mode=padding_mode,
                            align_corners=False)

    def k5b():
        return grid_sample_ops.grid_sample_dimg(grid, dout, shape,
                                                padding_mode)
    out = k5b()
    return (device_ms(k5b, per_call=per_call),
            device_ms(lambda: torch.autograd.grad(plain_out, (x,), dout,
                                                  retain_graph=True)),
            *bound(nbytes(grid, dout, out),
                   sampler_ops("grid_sample_dimg", grid.numel() // 2,
                               dout.shape[1])),
            device_ms(lambda: torch.autograd.grad(lib_out, (x,), dout,
                                                  retain_graph=True)))


def scaled_grid(N, size, scale, dev, seed=12):
    """An affine (N, size, size, 2) grid: ``scale`` times the identity,
    shifted by up to 0.1 of the half-width."""
    g = torch.Generator().manual_seed(seed)
    theta = torch.zeros(N, 2, 3)
    theta[:, 0, 0] = theta[:, 1, 1] = scale
    theta[:, :, 2] = (torch.rand(N, 2, generator=g) * 2 - 1) * 0.1
    return affine_grid(theta, (N, 1, size, size)).contiguous().to(dev)


def warp_ms(img, grid, padding_mode, backward=False):
    """Device time (ms) of one mipmap warp on these inputs (levels, Gaussian
    levels, sample), and of its mipmap kernels alone; with ``backward``, of
    the warp and its backward to the grid, as a train step takes it."""
    if backward:
        g = grid.detach().requires_grad_()
        cot = torch.randn(img.shape[0], img.shape[1], *grid.shape[1:3],
                          device=img.device,
                          generator=torch.Generator(img.device).manual_seed(9))

        def fn():
            return torch.autograd.grad(
                mipmap_warp(img, g, padding_mode=padding_mode), g, cot)
    else:
        def fn():
            with torch.inference_mode():
                return mipmap_warp(img, grid, padding_mode=padding_mode)
    return device_ms(fn), device_ms(fn, name="mipmap")


def k1_at_path_shapes(k1_calls, warps, card):
    """K1, its plain version and F.grid_sample on the volume, with K1's
    bounds, on the inputs each head of a served forward gave K1 at batch 40
    and 128; and the whole warp's device time on the same inputs. Returns
    the batch-128 figures per launch, averaged over the two heads."""
    rows = {}
    for b in BATCHES:
        for head, (args, out), wargs in zip(("similarity", "flow"),
                                            k1_calls[b], warps[b]):
            pyramid, grid, levels, pm = args
            img = wargs[0]
            with torch.inference_mode():
                ms = device_ms(lambda: mipmap_sample(*args))
                plain_ms = device_ms(lambda: _sample_pyramid(*args))
                stack = _rebuild_stack(pyramid)
                volume = as_volume(stack)
                grid3 = volume_grid(grid, levels, pyramid.shape.num_levels)
                lib_ms = device_ms(lambda: F.grid_sample(
                    volume, grid3, mode="bilinear", padding_mode=pm,
                    align_corners=False))
                io = nbytes(grid, levels, out)
                stack_b = bound(texel_bytes(stack, grid, levels, pm) + io,
                                sampler_ops("mipmap_sample", levels.numel(),
                                            out.shape[1]))
                del volume, grid3, stack
                pyr_b = bound(pyramid_texel_bytes(img.shape, grid, levels, pm)
                              + io, sampler_ops("mipmap_sample",
                                                levels.numel(), out.shape[1]))
                # the warp's two parts in torch ops
                lv_ms = device_ms(lambda: mipmap_levels(
                    grid, *img.shape[-2:], 3.5))
                build_ms = device_ms(lambda: _build_pyramid(
                    img, pyramid.shape.num_levels))
            w_ms, w_k_ms = warp_ms(img, grid, pm)
            print(f"K1 in the {head} head at batch {b}, levels "
                  f"{float(levels.min()):.2f}-{float(levels.max()):.2f}, "
                  f"device time: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"F.grid_sample on the volume {lib_ms:.4f} ms; bound on the "
                  f"pyramid {pyr_b[0]:.4f} ms ({pyr_b[1]}), on the stack "
                  f"{stack_b[0]:.4f} ms; the whole warp {w_ms:.4f} ms: "
                  f"levels {lv_ms:.4f} ms, pyramid {build_ms:.4f} ms, its "
                  f"mipmap kernels {w_k_ms:.4f} ms [{card}]")
            rows[b, head] = (ms, plain_ms, *pyr_b, lib_ms)
    return tuple(
        (rows[128, "similarity"][i] + rows[128, "flow"][i]) / 2
        if i != 3 else rows[128, "flow"][i] for i in range(5))


def kernel_groups(prof, groups):
    """Device time by kernel group of a torch.profiler run, its busy time,
    the span from the first kernel's start to the last one's end, and the
    time of each kernel name that fell in no group."""
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and SENTINEL not in e.name and e.name != RUN_RANGE]
    check(kernels, "the profiler saw no device activity")
    by_group, other = {}, {}
    for e in kernels:
        name = e.name.lower()
        group = next((g for g, keys in groups if any(k in name for k in keys)),
                     "elementwise and other")
        us = e.time_range.elapsed_us()
        by_group[group] = by_group.get(group, 0.0) + us
        if group == "elementwise and other":
            other[e.name] = other.get(e.name, 0.0) + us
    span = (max(e.time_range.end for e in kernels)
            - min(e.time_range.start for e in kernels))
    return by_group, sum(by_group.values()), span, other


CONV_GROUP = ("cuDNN convs and GEMMs", ("xmma", "gemm", "fft", "complex",
                                         "cudnn", "cutlass", "sm80_", "sm90_"))


def print_groups(what, n, by_group, busy, span, other, card, top=0):
    print(f"where the time goes, {what}: device busy {busy / 1e3:.3f} of "
          f"{span / 1e3:.3f} ms, idle share {1 - busy / span:.4f} [{card}]")
    for group, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"  {group}: {us / 1e3 / n:.3f} ms per {what.split()[0]} "
              f"({us / busy:.2%})")
    for name, us in sorted(other.items(), key=lambda kv: -kv[1])[:top]:
        print(f"    {us / 1e3 / n:.3f} ms ({us / busy:.2%}): {name[:110]}")


def where_time_goes(model, requests, card):
    """Device time of PROFILED forwards per batch size under torch.profiler,
    by kernel group, and the device's idle share: the part of the span from
    the first kernel's start to the last kernel's end in which no kernel
    ran (one stream, so kernels do not overlap)."""
    groups = (("K1 mipmap_sample", ("mipmap_pyramid_fwd",)),
              ("K2 grid_sample", ("grid_sample_kernel",)),
              ("depthwise FIR convs", ("conv_depthwise2d",)),
              CONV_GROUP,
              ("pads", ("pad",)),
              ("gather and index", ("gather", "index")))
    for b in BATCHES:
        congeal(model, requests[b][0])
        torch.cuda.synchronize()
        prof = profiled(lambda: [congeal(model, requests[b][i % REQUESTS])
                                 for i in range(PROFILED)])
        print_groups(f"forward at batch {b}, {PROFILED} forwards", PROFILED,
                     *kernel_groups(prof, groups), card)


def smooth_images(n, generator):
    """Images without pixel-scale detail: tanh of bilinearly upsampled 16x16
    noise. A warp without anti-aliasing carries the last-bit differences of
    its coordinates times the image gradient into its output, and white
    noise has the largest gradient an image can have."""
    low = torch.randn(n, 3, 16, 16, generator=generator)
    return torch.tanh(2 * interpolate_bilinear(low, 256, 256))


def card_vs_cpu(card_model, cpu_model, x, what):
    """The same forward on the card and on the port's CPU path."""
    got = congeal(card_model, x.to(next(card_model.parameters()).device))
    ref = congeal(cpu_model, x)
    errs = [float((a.cpu() - b).abs().max()) for a, b in zip(got, ref)]
    print(f"card vs CPU path, {what}, batch {x.shape[0]}: out {errs[0]:.3e} "
          f"grid {errs[1]:.3e} flow {errs[2]:.3e}")
    check(errs[0] <= OUT_TOL, f"{what}: out differs from the CPU path")
    check(errs[1] <= GRID_TOL and errs[2] <= GRID_TOL,
          f"{what}: grid or flow differs from the CPU path")


def zero_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def timed_parts(run_part, check_result):
    """CUDA-event time (ms) of each of SUBWINDOWS calls of ``run_part(w)``,
    whose results are checked after the part's end event."""
    ms = []
    for w in range(SUBWINDOWS):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        results = run_part(w)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
        for r in results:
            check_result(r)
    return ms


def serve(dev, card):
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "stn.pt")
        make_checkpoint(path)
        model, cfg = load_stn(path, supersize=256, device=dev)
        cpu_model, _ = load_stn(path, supersize=256, device="cpu")
    check(cfg == FLAGSHIP, f"load_stn built {cfg}")
    no_aa_cfg = dataclasses.replace(cfg, antialias=False)
    no_aa = ComposedSTN(no_aa_cfg, device=dev)
    no_aa.load_state_dict(model.state_dict())
    cpu_no_aa = ComposedSTN(no_aa_cfg).eval()
    cpu_no_aa.load_state_dict(cpu_model.state_dict())

    g = torch.Generator(device=dev).manual_seed(1)
    requests = {b: [torch.rand(b, 3, 256, 256, device=dev, generator=g) * 2 - 1
                    for _ in range(REQUESTS)] for b in BATCHES}
    torch.cuda.synchronize()

    # the main path: every launch count starts at 0 here
    zero_launches()
    forwards = 0
    rates, peak_gib = {}, {}
    for b in BATCHES:
        check_outputs(congeal(model, requests[b][0]), b)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        check_outputs(congeal(model, requests[b][1]), b)
        peak_gib[b] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        forwards += 2
        part = TIMED[b] // SUBWINDOWS
        ms = timed_parts(
            lambda w: [congeal(model, requests[b][(w * part + i) % REQUESTS])
                       for i in range(part)],
            lambda r: check_outputs(r, b))
        forwards += TIMED[b]
        rates[b] = (b * part * SUBWINDOWS / (sum(ms) / 1e3),
                    [b * part / (t / 1e3) for t in ms], sum(ms) / 1e3)
    check_outputs(congeal(no_aa, requests[40][0]), 40)
    launches = dict(LAUNCHES)
    print(f"main path: {forwards} antialiased forwards and 1 antialias=False "
          f"forward; launches {launches}")
    check(launches["mipmap_sample"] == 2 * forwards,
          f"mipmap kernel launched {launches['mipmap_sample']} times for "
          f"{forwards} forwards, expected 2 per forward")
    check(launches["grid_sample"] == 2,
          f"grid-sample kernel launched {launches['grid_sample']} times in "
          "one antialias=False forward, expected 2")

    path_err, k1_calls, warps, k2_calls = kernels_at_path_shapes(
        model, no_aa, requests)
    k1_path = k1_at_path_shapes(k1_calls, warps, card)
    # K5a on each head's grid over the 256 px source at the levels it gave
    # K1 (clones: a tensor made in inference mode cannot enter autograd)
    dout = torch.randn(40, 3, 128, 128, device=dev, generator=g)
    k5a_times([(f"the {head} head's grid of a served batch-40 forward",
                args[0].shape, args[1].clone(), args[2].clone(), dout,
                args[3])
               for head, (args, _) in zip(("similarity", "flow"),
                                          k1_calls[40])], card)
    del k1_calls, warps, dout
    # K2 on the inputs each head of the antialias=False forward gave it
    for head, (args, _) in zip(("similarity", "flow"), k2_calls):
        print_k2(f"in the {head} head of an antialias=False forward at "
                 f"batch 40", args[0], args[1], k2_times(*args), card)
    del k2_calls
    g4 = torch.Generator().manual_seed(2)
    card_vs_cpu(model, cpu_model,
                torch.rand(4, 3, 256, 256, generator=g4) * 2 - 1,
                "antialiased forward, noise images")
    card_vs_cpu(no_aa, cpu_no_aa, smooth_images(4, g4),
                "antialias=False forward, smooth images")
    where_time_goes(model, requests, card)
    return rates, peak_gib, launches, path_err, k1_path


def train_argv(results, gpath):
    """The reference's LSUN-cats run (scripts/training/lsun_cats_ssl.sh) on
    one card at the global batch of 40, for TRAIN_ITERS iterations."""
    return ["--exp-name", "smoke", "--results", results, "--ckpt", gpath,
            "--load_G_only", "--padding_mode", "border", "--tv_weight", "1000",
            "--loss_fn", "vgg_ssl", "--ndirs", "1", "--inject", "5",
            "--gen_size", "256", "--dim_latent", "512", "--n_mlp", "8",
            "--gen_channel_multiplier", "2", "--flow_size", "128",
            "--stn_channel_multiplier", "0.5", "--real_size", "256",
            "--batch", str(TRAIN_BATCH), "--iter", str(TRAIN_ITERS),
            "--ckpt_every", "2", "--vis_every", "0", "--log_every", "1"]


def scaled_err(ours, ref):
    return (float((ours - ref).abs().max()),
            float((ours - ref).abs().max()) / max(1.0, float(ref.abs().max())))


def hold(name, pairs, errs):
    """Each (ours, ref) within KERNEL_TOL scaled by max(1, max|ref|)."""
    for ours, ref in pairs:
        err, scaled = scaled_err(ours, ref)
        check(scaled <= KERNEL_TOL, f"{name} disagrees with its plain "
              f"version: {err:.3e} ({scaled:.3e} scaled)")
        errs[name] = max(errs.get(name, 0.0), err)


# Each takes a backward kernel's recorded arguments and returns the plain
# version's output, the inputs to differentiate it by, and the cotangent.
def k3_graph(a):
    pyramid, grid, levels, dout, pm = a
    g = grid.detach().requires_grad_()
    lv = levels.detach().requires_grad_()
    return _sample_pyramid(pyramid, g, lv, pm), (g, lv), dout


def k4_graph(a):
    img, grid, dout, pm = a
    g = grid.detach().requires_grad_()
    return grid_sample(img, g, padding_mode=pm), (g,), dout


def k5a_graph(a):
    shape, grid, levels, dout, pm = a
    N, dev = grid.shape[0], grid.device
    level0 = torch.zeros(N, shape.channels, shape.size, shape.size,
                         device=dev, requires_grad=True)
    coarse = torch.zeros(N, mipmap_ops._coarse_floats(shape), device=dev,
                         requires_grad=True)
    return (_sample_pyramid(mipmap_ops.Pyramid(level0, coarse, shape), grid,
                            levels, pm), (level0, coarse), dout)


def k5b_graph(a):
    grid, dout, input_shape, pm = a
    x = torch.zeros(input_shape, device=grid.device, requires_grad=True)
    return grid_sample(x, grid, padding_mode=pm), (x,), dout


def k5b_checks(k5b, errs, card):
    """K5b beyond the recorded launches: on the check's d/dout and image
    shape (40, 3, 128, 128, from 128 x 128 points), the identity grid, the
    similarity head's recorded grid, a zoom-in and a border pile (SKEWED),
    each in the three padding modes, held against the plain autograd and
    run three times, equal to the bit; the skewed ones timed under border
    padding."""
    grid, dout, shape, _ = k5b[0][0]
    N, dev = shape[0], grid.device
    grids = {"identity": grid_sample_ops.identity_grid(N, 128, 128,
                                                       device=dev),
             "affine": grid}
    grids.update({k: scaled_grid(N, 128, s, dev) for k, s in SKEWED.items()})
    for kind, g in grids.items():
        for pm in PADDINGS:
            runs = [grid_sample_ops.grid_sample_dimg(g, dout, shape, pm)
                    for _ in range(3)]
            check(all(torch.equal(runs[0], r) for r in runs[1:]),
                  f"K5b gave other bits on the same inputs ({kind}, {pm})")
            hold("grid_sample_dimg", backward_pairs(
                [((g, dout, shape, pm), runs[0])], k5b_graph), errs)
    print(f"K5b on identity, affine, zoom-in and border-pile grids over "
          f"{tuple(shape)} in the three padding modes: max abs err vs the "
          f"plain autograd {errs['grid_sample_dimg']:.3e} (tolerance "
          f"{KERNEL_TOL:g} scaled by max(1, max|ref|)), three launches each "
          f"equal to the bit")
    for kind in SKEWED:
        t = k5b_times(grids[kind], dout, shape)
        print(f"K5b on the {kind} grid, {tuple(shape)} from "
              f"{tuple(grids[kind].shape)}, border, device time: kernels "
              f"{t[0]:.4f} ms, plain autograd {t[1]:.4f} ms, backward of "
              f"F.grid_sample to the image {t[4]:.4f} ms; bound {t[2]:.4f} "
              f"ms ({t[3]}) [{card}]")


def k5a_checks(k5a, errs):
    """K5a beyond the recorded launches: on the check's d/dout and pyramid
    (of a (40, 3, 128, 128) image), the identity grid, the recorded grid
    whose levels span the most, a zoom-in and a border pile (SKEWED), each
    at the levels the warp gives it (the recorded ones for the recorded
    grid) in the three padding modes, held against the plain autograd and
    run three times, equal to the bit. Returns the skewed inputs."""
    args = max((a for a, _ in k5a), key=lambda a: float(a[2].max()))
    shape, grid, levels, dout, _ = args
    N, dev, H = grid.shape[0], grid.device, shape.height

    def with_levels(g):
        return g, mipmap_ops.jmax(mipmap_levels(g, H, H, 3.5),
                                  0.0).contiguous()
    grids = {"identity": with_levels(grid_sample_ops.identity_grid(
        N, *grid.shape[1:3], device=dev)), "recorded": (grid, levels)}
    grids.update({k: with_levels(scaled_grid(N, grid.shape[1], s, dev))
                  for k, s in SKEWED.items()})
    for kind, (g, lv) in grids.items():
        for pm in PADDINGS:
            runs = [mipmap_ops.mipmap_sample_dpyramid(shape, g, lv, dout, pm)
                    for _ in range(3)]
            check(all(torch.equal(a, b) for r in runs[1:]
                      for a, b in zip(runs[0], r)),
                  f"K5a gave other bits on the same inputs ({kind}, {pm})")
            hold("mipmap_sample_dpyramid", backward_pairs(
                [((shape, g, lv, dout, pm), runs[0])], k5a_graph), errs)
    print(f"K5a on identity, recorded, zoom-in and border-pile grids over "
          f"{(N, shape.channels, H, shape.width)} in the three padding "
          f"modes: max abs err vs the plain autograd "
          f"{errs['mipmap_sample_dpyramid']:.3e} (tolerance {KERNEL_TOL:g} "
          f"scaled by max(1, max|ref|)), three launches each equal to the "
          f"bit")
    return [(f"the {k} grid", shape, *grids[k], dout, "border")
            for k in SKEWED]


def parent_route_ms(shape, N, dev):
    """Device time of the parts of the parent commit's K5a route that were
    torch ops: the zero fill of a full-resolution (N, D, C, H, W) d/dstack,
    and its map to the pyramid's gradient, the autograd of the crop, the
    stack and the upsampling of ``_rebuild_stack`` (its atomic scatter into
    the stack is timed by ``chip_mipmap_variants.py --tree`` on the parent's
    tree)."""
    stack_shape = (N, shape.num_levels, shape.channels, shape.height,
                   shape.width)
    level0 = torch.zeros(N, shape.channels, shape.size, shape.size,
                         device=dev, requires_grad=True)
    # (the coarse levels' floats counted here: the parent's package, which
    # chip_mipmap_variants.py --tree imports, has no _coarse_floats)
    coarse = torch.zeros(N, sum(shape.texel() * s * s
                                for s in shape.sides()[1:]),
                         device=dev, requires_grad=True)
    dstack = torch.randn(stack_shape, device=dev,
                         generator=torch.Generator(dev).manual_seed(4))

    def adjoint():
        stack = _rebuild_stack(mipmap_ops.Pyramid(level0, coarse, shape))
        return torch.autograd.grad(stack, (level0, coarse), dstack)
    return (device_ms(lambda: torch.zeros(stack_shape, device=dev)),
            device_ms(adjoint))


def k5a_times(cases, card):
    """K5a on each case's inputs (what, pyramid shape, grid, levels, dout,
    padding): its three kernels' device time and its split, the plain
    autograd's, the backward of F.grid_sample to the stack as a volume
    (d/dstack alone, less work than K5a's route, which also maps it to the
    pyramid), two bounds (bytes that write the pyramid's gradient once,
    K5a's own count, and bytes that write the stack, the parent route's)
    and the parent route's torch parts."""
    for what, *args in cases:
        shape, grid, levels, dout, _ = args
        N, dev = grid.shape[0], grid.device
        t = backward_times([(tuple(args), mipmap_ops.mipmap_sample_dpyramid(
            *args))], k5a_graph, mipmap_ops.mipmap_sample_dpyramid)
        split = [device_ms(lambda: mipmap_ops.mipmap_sample_dpyramid(*args),
                           name=k, per_call=1) for k in K5A_KERNEL_NAMES]
        stack_bytes = 4 * N * shape.num_levels * shape.channels * \
            shape.height * shape.width
        old = bound(nbytes(grid, levels, dout) + stack_bytes,
                    sampler_ops("mipmap_sample_dpyramid", levels.numel(),
                                shape.channels))
        fill_ms, adjoint_ms = parent_route_ms(shape, N, dev)
        image = (N, shape.channels, shape.height, shape.width)
        print(f"K5a on {what}, pyramid of {image} (side {shape.size}), "
              f"grid {tuple(grid.shape)}, levels "
              f"{float(levels.min()):.2f}-{float(levels.max()):.2f}, device "
              f"time: kernels {t[0]:.4f} ms (bin {split[0]:.4f}, gather "
              f"{split[1]:.4f}, merge {split[2]:.4f}), plain autograd "
              f"{t[1]:.4f} ms, backward of F.grid_sample to the volume "
              f"(d/dstack only) {t[4]:.4f} ms; bound writing the pyramid's "
              f"gradient {t[2]:.4f} ms ({t[3]}), writing the stack "
              f"{old[0]:.4f} ms; the parent route's torch parts: zero fill "
              f"{fill_ms:.4f} ms, rebuild adjoint {adjoint_ms:.4f} ms "
              f"[{card}]")


def backward_pairs(calls, graph_of):
    """(kernel output, plain autograd) for each recorded backward launch."""
    pairs = []
    for args, out in calls:
        plain_out, inputs, dout = graph_of(args)
        refs = torch.autograd.grad(plain_out, inputs, dout)
        outs = out if isinstance(out, tuple) else (out,)
        pairs += list(zip(outs, refs))
    return pairs


def backward_times(calls, graph_of, kernel):
    """Device time of a backward kernel on its first recorded launch's
    inputs and of the plain version's backward (its graph built once), the
    kernel's bound on those inputs, and the device time of the backward of
    F.grid_sample that computes the same function: on the image for the
    grid-sample kernels, on the stack as a volume for the mipmap ones."""
    args, out = calls[0]
    plain_out, inputs, dout = graph_of(args)
    name = kernel.__name__
    grid = next(a for a in args if torch.is_tensor(a) and a.shape[-1] == 2)
    writes = list(out) if isinstance(out, tuple) else [out]
    # the bytes each must read: of the image or stack, only the taps
    if name == "mipmap_sample_dcoords":
        # pyramid, grid, levels, dout, padding: the pyramid's texels that
        # the levels with a nonzero tent or tent slope reach
        moved = pyramid_texel_bytes(image_shape(args[0]), *args[1:3],
                                    args[4], dcoords=True) + \
            nbytes(*args[1:4])
    elif name == "grid_sample_dgrid":  # img, grid, dout, padding
        moved = texel_bytes(args[0], grid, padding_mode=args[3]) + \
            nbytes(*args[1:3])
    else:
        moved = nbytes(*(a for a in args if torch.is_tensor(a)))
    moved += nbytes(*writes)
    pm = args[-1]
    if name == "grid_sample_dgrid":
        x, g = args[0], grid.detach().requires_grad_()
        wrt = g
    elif name == "grid_sample_dimg":
        x = wrt = torch.zeros(args[2], device=grid.device,
                              requires_grad=True)
        g = grid
    elif name == "mipmap_sample_dcoords":
        x = as_volume(_rebuild_stack(args[0]))
        g = wrt = volume_grid(grid, args[2], x.shape[2]).requires_grad_()
    else:  # mipmap_sample_dpyramid: shape, grid, levels, dout, padding
        shape = args[0]
        x = wrt = torch.zeros(grid.shape[0], shape.channels,
                              shape.num_levels, shape.height, shape.width,
                              device=grid.device, requires_grad=True)
        g = volume_grid(grid, args[2], shape.num_levels)
    lib_out = F.grid_sample(x, g, padding_mode=pm, align_corners=False)
    lib_dout = dout[:, :, None] if lib_out.ndim == 5 else dout
    per_call = {"grid_sample_dimg": K5B_KERNELS,
                "mipmap_sample_dpyramid": len(K5A_KERNEL_NAMES)}.get(name)
    return (device_ms(lambda: kernel(*args), per_call=per_call),
            device_ms(lambda: torch.autograd.grad(plain_out, inputs, dout,
                                                  retain_graph=True)),
            *bound(moved, sampler_ops(name, grid.numel() // 2,
                                      dout.shape[1])),
            device_ms(lambda: torch.autograd.grad(lib_out, (wrt,), lib_dout,
                                                  retain_graph=True)))


def cli_run(dev):
    """python -m gangealing_torch.cli.train in process, from a seeded random
    G saved in the reference schema; then the scalars and the last
    checkpoint, resumed into a fresh state."""
    d = tempfile.mkdtemp()
    gpath = os.path.join(d, "g.pt")
    gen = Generator(GeneratorConfig(), generator=torch.Generator().manual_seed(3))
    torch.save({"g_ema": gen.state_dict()}, gpath)
    del gen
    zero_launches()
    t0 = time.perf_counter()
    state, generator, perceptual, pfn = train_cli.main(
        train_argv(os.path.join(d, "results"), gpath))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    print(f"cli.train: {TRAIN_ITERS} iterations at batch {TRAIN_BATCH} with "
          f"the cold start in {seconds:.1f} s; launches {launches}")
    check(launches["mipmap_sample"] == 2 * TRAIN_ITERS
          and launches["mipmap_sample_dcoords"] == 2 * TRAIN_ITERS,
          "expected 2 K1 and 2 K3 launches per train step")
    check(launches["mipmap_sample_dpyramid"] == 0,
          "K5a launched for a pyramid that needs no gradient")
    run_dir = os.path.join(d, "results", "smoke")
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        scalars = [json.loads(line) for line in f if line.strip()]
    check({s["step"] for s in scalars} == set(range(1, TRAIN_ITERS + 1)),
          "scalars.jsonl misses iterations")
    check(all(math.isfinite(s["value"]) for s in scalars),
          "scalars.jsonl holds a value that is not finite")
    last = {s["name"]: s["value"] for s in scalars if s["step"] == TRAIN_ITERS}
    print(f"scalars at iteration {TRAIN_ITERS}: {last}")
    ckpts = sorted(os.listdir(os.path.join(run_dir, "checkpoints")))
    check(ckpts == ["0000002.pt", "0000004.pt"], f"checkpoints {ckpts}")
    cfg = state.cfg
    fresh = TrainState(cfg, ComposedSTN(cfg.t, device=dev),
                       LatentLearner(cfg.ll, device=dev))
    train_ckpt.resume(fresh, train_ckpt.load_checkpoint(
        os.path.join(run_dir, "checkpoints", ckpts[-1])))
    for a, b in ((fresh.t, state.t), (fresh.t_ema, state.t_ema),
                 (fresh.ll, state.ll)):
        for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            check(torch.equal(x, y), f"resumed {k} differs")
    for a, b in ((fresh.t_optim, state.t_optim), (fresh.ll_optim,
                                                   state.ll_optim)):
        sa, sb = a.state_dict()["state"], b.state_dict()["state"]
        check(sa.keys() == sb.keys() and all(
            torch.equal(sa[i][m], sb[i][m]) for i in sa
            for m in ("exp_avg", "exp_avg_sq")), "resumed Adam state differs")
    print(f"checkpoint {ckpts[-1]} resumed: parameters, EMA and Adam moments "
          "equal")
    shutil.rmtree(d)
    return state, generator, perceptual, pfn, launches


def train(dev, card):
    state, generator, perceptual, pfn, cli_launches = cli_run(dev)
    cfg = state.cfg
    rng = torch.Generator(dev).manual_seed(5)

    def step(st=state):
        z = torch.randn(TRAIN_BATCH, cfg.g.style_dim, generator=rng,
                        device=dev)
        return train_step(st, generator, pfn, z, 0.5, 1e-3, 1e-2, rng=rng)

    for _ in range(2):  # warm-up
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_launches()
    metrics = step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    per_step = dict(LAUNCHES)
    check(per_step["mipmap_sample"] == 2
          and per_step["mipmap_sample_dcoords"] == 2
          and sum(per_step.values()) == 4,
          f"one train step launched {per_step}, expected K1 2, K3 2")
    check(all(math.isfinite(float(v)) for v in metrics.values()),
          f"train step metrics {metrics}")
    part = TRAIN_TIMED // SUBWINDOWS
    ms = timed_parts(lambda w: [step() for _ in range(part)],
                     lambda m: check(all(math.isfinite(float(v))
                                         for v in m.values()),
                                     "a timed step is not finite"))
    rate = TRAIN_BATCH * TRAIN_TIMED / (sum(ms) / 1e3)
    print(f"train batch {TRAIN_BATCH}: {rate:.1f} imgs/s over {TRAIN_TIMED} "
          f"steps in {sum(ms) / 1e3:.2f} s (in {SUBWINDOWS} parts: "
          f"{', '.join(f'{TRAIN_BATCH * part / (t / 1e3):.1f}' for t in ms)})"
          f", peak memory of a step {peak:.2f} GiB [{card}]")

    # the perceptual term alone, from an identity-initialised STN
    t_id = ComposedSTN(cfg.t, device=dev,
                       generator=torch.Generator().manual_seed(6))
    z = torch.randn(TRAIN_BATCH, cfg.g.style_dim, generator=rng, device=dev)
    ploss, _ = gangealing_loss(generator, t_id, state.ll, pfn, z, 0.5,
                               padding_mode=cfg.padding_mode, rng=rng)
    ploss.backward()
    head = t_id.stns[0].warp_head.linear
    gmax = max(float(head.weight.grad.abs().max()),
               float(head.bias.grad.abs().max()))
    check(math.isfinite(gmax) and gmax > 0, "the perceptual loss does not "
          "reach the similarity head")
    print(f"perceptual term alone, identity STN: largest similarity-head "
          f"gradient {gmax:.3e}")

    # each K1 and K3 launch of a step from the trained state, and of one
    # from the identity init, where every point sits on an integer
    # coordinate, the first row and column on the border clamp and every
    # level on 1
    errs = {}
    st_id = TrainState(cfg, copy.deepcopy(t_id), copy.deepcopy(state.ll))
    for what, st in (("trained state", state), ("identity init", st_id)):
        with recorded(mipmap_ops, "mipmap_sample") as k1, \
                recorded(mipmap_ops, "mipmap_sample_dcoords") as k3, \
                recorded(stn_ops, "mipmap_warp") as warps:
            step(st)
        check(len(k1) == 2 and len(k3) == 2, f"a step from the {what} did "
              "not launch K1 and K3 twice")
        if what == "trained state":
            k3_trained, warps_trained = k3, warps
        step_errs = {}
        with torch.no_grad():
            hold("mipmap_sample", [(out, _sample_pyramid(*a)) for a, out in k1],
                 step_errs)
        hold("mipmap_sample_dcoords", backward_pairs(k3, k3_graph), step_errs)
        for k, v in step_errs.items():
            errs[k] = max(errs.get(k, 0.0), v)
        print(f"K1 and K3 launches of a train step from the {what}, inputs "
              f"{tuple(k3[0][0][0].level0.shape)} {tuple(k3[0][0][1].shape)}: max "
              f"abs err K1 {step_errs['mipmap_sample']:.3e}, K3 "
              f"{step_errs['mipmap_sample_dcoords']:.3e}")
    k3 = k3_trained
    # K3 where every level lies one float step below an integer: there
    # |level - (f + 2)| rounds to 1, the kink of level f + 2's tent
    pyramid, grid, lv, dout, pm = k3[0][0]
    below = torch.nextafter(torch.round(lv) + 1, torch.zeros_like(lv))
    args = (pyramid, grid, below.contiguous(), dout, pm)
    step_errs = {}
    hold("mipmap_sample_dcoords", backward_pairs(
        [(args, mipmap_ops.mipmap_sample_dcoords(*args))], k3_graph),
        step_errs)
    errs["mipmap_sample_dcoords"] = max(errs["mipmap_sample_dcoords"],
                                        step_errs["mipmap_sample_dcoords"])
    print(f"K3 on those inputs with every level a float step below an "
          f"integer: max abs err {step_errs['mipmap_sample_dcoords']:.3e}")

    # antialias=False: K2 forward, K4 backward
    no_aa_cfg = dataclasses.replace(cfg, t=dataclasses.replace(
        cfg.t, antialias=False))
    t_no_aa = ComposedSTN(no_aa_cfg.t, device=dev)
    t_no_aa.load_state_dict(state.t.state_dict())
    st_no_aa = TrainState(no_aa_cfg, t_no_aa, copy.deepcopy(state.ll))
    zero_launches()
    with recorded(grid_sample_ops, "grid_sample_cuda") as k2, \
            recorded(grid_sample_ops, "grid_sample_dgrid") as k4:
        step(st_no_aa)
    torch.cuda.synchronize()
    no_aa_launches = dict(LAUNCHES)
    check(no_aa_launches["grid_sample"] == 2
          and no_aa_launches["grid_sample_dgrid"] == 2
          and no_aa_launches["mipmap_sample"] == 0,
          f"the antialias=False step launched {no_aa_launches}")
    with torch.no_grad():
        hold("grid_sample", [(out, grid_sample(a[0], a[1], padding_mode=a[2]))
                             for a, out in k2], errs)
    hold("grid_sample_dgrid", backward_pairs(k4, k4_graph), errs)

    # an input image that needs a gradient: K5a and K5b
    x = (torch.rand(TRAIN_BATCH, 3, 128, 128, generator=rng, device=dev)
         * 2 - 1).requires_grad_()
    cot = torch.randn(TRAIN_BATCH, 3, 128, 128, generator=rng, device=dev)
    zero_launches()
    with recorded(mipmap_ops, "mipmap_sample_dpyramid") as k5a, \
            recorded(grid_sample_ops, "grid_sample_dimg") as k5b:
        loss = ((state.t(x)[0] + t_no_aa(x)[0]) * cot).sum()
        loss.backward()
    torch.cuda.synchronize()
    image_launches = dict(LAUNCHES)
    check(image_launches["mipmap_sample_dpyramid"] == 2
          and image_launches["grid_sample_dimg"] == 2,
          f"a forward with an input that needs a gradient launched "
          f"{image_launches}")
    hold("mipmap_sample_dpyramid", backward_pairs(k5a, k5a_graph), errs)
    hold("grid_sample_dimg", backward_pairs(k5b, k5b_graph), errs)
    k5a_skewed = k5a_checks(k5a, errs)
    k5b_checks(k5b, errs, card)
    print(f"K2 and K4 launches of an antialias=False step, K5a and K5b of a "
          f"forward whose input needs a gradient: max abs err K2 "
          f"{errs['grid_sample']:.3e}, K4 {errs['grid_sample_dgrid']:.3e}, "
          f"K5a {errs['mipmap_sample_dpyramid']:.3e}, K5b "
          f"{errs['grid_sample_dimg']:.3e}")

    times = {
        "mipmap_sample_dcoords": backward_times(
            k3, k3_graph, mipmap_ops.mipmap_sample_dcoords),
        "grid_sample_dgrid": backward_times(
            k4, k4_graph, grid_sample_ops.grid_sample_dgrid),
        "mipmap_sample_dpyramid": backward_times(
            k5a, k5a_graph, mipmap_ops.mipmap_sample_dpyramid),
        "grid_sample_dimg": backward_times(
            k5b, k5b_graph, grid_sample_ops.grid_sample_dimg),
    }
    # K5a on each head's recorded launch over the check's image and on the
    # skewed grids
    k5a_times([(f"the recorded launch {i + 1} of the check", *a)
               for i, (a, _) in enumerate(k5a)] + k5a_skewed, card)
    for head, (args, _) in zip(("similarity", "flow"), warps_trained):
        img, grid, _, pm = args
        w_ms, w_k_ms = warp_ms(img.detach(), grid.detach(), pm, backward=True)
        print(f"the mipmap warp and its backward to the grid in the {head} "
              f"head of a train step at batch {TRAIN_BATCH}, inputs "
              f"{tuple(img.shape)} {tuple(grid.shape)}, device time: "
              f"{w_ms:.4f} ms, its mipmap kernels {w_k_ms:.4f} ms [{card}]")
    for name, (ms_k, ms_p, b_ms, b_by, lib_ms) in times.items():
        on = " on the volume" if name.startswith("mipmap") else ""
        print(f"{name} at the train step's shapes, device time: kernel "
              f"{ms_k:.4f} ms, plain autograd {ms_p:.4f} ms, backward of "
              f"F.grid_sample{on} {lib_ms:.4f} ms; bound {b_ms:.4f} ms "
              f"({b_by}) [{card}]")

    groups = (("K1 mipmap_sample", ("mipmap_pyramid_fwd",)),
              ("K3 mipmap d/dcoords", ("mipmap_pyramid_dcoords",)),
              ("depthwise FIR convs", ("conv_depthwise2d",)),
              CONV_GROUP,
              ("Adam and EMA (multi-tensor)", ("multi_tensor",)),
              ("reductions", ("reduce",)),
              ("pads", ("pad",)),
              ("gather, scatter and index", ("gather", "scatter", "index")))
    step()
    torch.cuda.synchronize()
    prof = profiled(lambda: [step() for _ in range(2)])
    print_groups(f"step at batch {TRAIN_BATCH}, 2 steps", 2,
                 *kernel_groups(prof, groups), card, top=8)

    card_vs_cpu_step(cfg, state.t, state.ll, generator, perceptual, dev,
                     "trained state")
    card_vs_cpu_step(cfg, t_id, state.ll, generator, perceptual, dev,
                     "identity init")
    # the side checks' launches, apart from the main path's (cli.train)
    check_launches = {k: no_aa_launches[k] + image_launches[k]
                      for k in LAUNCHES}
    return rate, peak, cli_launches, check_launches, errs, times


def step_batch2(cfg):
    """z and the generator's noise of a batch-2 step, from a seed."""
    g = torch.Generator().manual_seed(7)
    z = torch.randn(2, cfg.g.style_dim, generator=g)
    shapes = cfg.g.noise_shapes(2)
    return z, [[torch.randn(s, generator=g) for s in shapes] for _ in range(2)]


def step_grads(cfg, t, ll, generator, perceptual, d, z, noise):
    """One step's loss terms and the gradients of every STN and ``ll``
    parameter on device ``d``, from copies of the modules."""
    loss = make_perceptual_loss(cfg.loss_fn)
    gen = copy.deepcopy(generator).to(d)
    vgg = copy.deepcopy(perceptual).to(d)
    st = TrainState(cfg, copy.deepcopy(t).to(d), copy.deepcopy(ll).to(d))
    m = train_step(st, gen, lambda x, y: loss(vgg, x, y), z.to(d), 0.5,
                   0.0, 0.0, noise=[[n.to(d) for n in ns] for ns in noise])
    grads = {k: p.grad.cpu() for k, p in st.t.named_parameters()}
    grads["ll.coefficients"] = st.ll.coefficients.grad.cpu()
    return {k: float(v) for k, v in m.items()}, grads


def compare_steps(card, cpu):
    """Largest relative loss-term error, the worst gradient tensor's error
    over its largest CPU value with its name, and the relative L2 error of
    all gradients as one vector."""
    (m_card, g_card), (m_cpu, g_cpu) = card, cpu
    rel = max(abs(m_card[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-30)
              for k in m_cpu)
    worst = max(((float((g_card[k] - r).abs().max())
                  / max(float(r.abs().max()), 1e-30), k)
                 for k, r in g_cpu.items()))
    flat_card = torch.cat([g.flatten() for g in g_card.values()])
    flat_cpu = torch.cat([g_cpu[k].flatten() for k in g_card])
    return rel, worst, float((flat_card - flat_cpu).norm() / flat_cpu.norm())


def card_vs_cpu_step(cfg, t, ll, generator, perceptual, dev, what):
    """One step's loss terms and gradients at batch 2, on the card and on
    the port's CPU path, from the same STN ``t``, ``ll``, z and noise."""
    z, noise = step_batch2(cfg)
    runs = [step_grads(cfg, t, ll, generator, perceptual, d, z, noise)
            for d in (dev, torch.device("cpu"))]
    rel, worst, l2 = compare_steps(*runs)
    print(f"card vs CPU path, one train step from the {what} at batch 2: "
          f"loss terms {runs[0][0]} vs {runs[1][0]} (relative {rel:.3e}); "
          f"worst gradient {worst[1]} at {worst[0]:.3e} of its largest "
          f"value; all gradients {l2:.3e} in relative L2 norm")
    check(rel <= 1e-4, f"{what}: a loss term differs from the CPU path")
    check(worst[0] <= TRAIN_GRAD_TOL and l2 <= TRAIN_GRAD_L2_TOL,
          f"{what}: the gradients differ from the CPU path")


def synthetic_label(size=128, radius=LABEL_RADIUS):
    """A dense label in the congealed space of the flagship (flow_size 128
    px), as load_dense_label returns one: an opaque disc centred in the
    image with colours that vary smoothly across it, its pixels in
    row-major order. Returns (points (1, P, 2) x then y, colors (1, P, 3)
    in [-1, 1], alphas (1, P, 1)) as float32 tensors, and the RGBA image."""
    c = (size - 1) / 2
    yy, xx = np.mgrid[:size, :size]
    ii, jj = np.where((xx - c) ** 2 + (yy - c) ** 2 <= radius ** 2)
    points = np.stack([jj, ii], -1)[None].astype(np.float32)
    colors = np.stack([np.sin(jj / 9.0), np.cos(ii / 11.0),
                       (ii + jj) / (size - 1.0) - 1.0], -1)[None]
    rgba = np.zeros((size, size, 4), np.uint8)
    rgba[ii, jj, :3] = np.round((colors[0] + 1) * 127.5).astype(np.uint8)
    rgba[ii, jj, 3] = 255
    alphas = np.ones((1, points.shape[1], 1), np.float32)
    return tuple(torch.from_numpy(a) for a in
                 (points, colors.astype(np.float32), alphas)), rgba


def ar_run(model, frames, label, **kw):
    """The AR app on ``frames`` with the synthetic label at the eval batch,
    sigma 1.2, opacity 1, flip inference on."""
    points, colors, alphas = label
    return run_gangealing_on_video(model, frames, points=points,
                                   colors=colors, alphas=alphas,
                                   sigma=AR_SIGMA, opacity=1.0,
                                   batch=AR_BATCH, **kw)


def check_ar(result, n, keys=("propagated", "congealed")):
    for key in keys:
        check(result[key].shape == (n, 3, 256, 256),
              f"AR {key} shape {result[key].shape}")
        check(bool(np.isfinite(result[key]).all()),
              f"AR {key} is not finite")


def write_label(rgba, out):
    """The synthetic label as an RGBA PNG, as the apps read a label."""
    from PIL import Image
    label = os.path.join(out, "label.png")
    Image.fromarray(rgba).save(label)
    return label


def images_run(model, frames, label_png):
    """apps/propagate_to_images on ``frames`` with the label's own colours
    (objects=True) at the eval batch, sigma 1.2, opacity 1, flip inference
    on."""
    return propagate_to_images(model, frames, label_path=label_png,
                               sigma=AR_SIGMA, opacity=1.0, batch=AR_BATCH,
                               objects=True)


def check_images(result, n):
    check_ar(result, n)
    check(result["average_congealed"].shape == (1, 3, 256, 256)
          and bool(np.isfinite(result["average_congealed"]).all()),
          "propagate_to_images: average_congealed")


def ar_cli(path, frames, label, out):
    """python -m gangealing_torch.cli.mixed_reality in process, on a
    directory of PNG frames with the label as an RGBA PNG."""
    from PIL import Image
    fdir = os.path.join(out, "frames_in")
    os.makedirs(fdir)
    for i, f in enumerate(frames):
        Image.fromarray(np.round((f + 1) * 127.5).astype(np.uint8).transpose(
            1, 2, 0)).save(os.path.join(fdir, f"{i}.png"))
    t0 = time.perf_counter()
    result = mixed_reality_cli.main([
        "--ckpt", path, "--video_path", fdir, "--label_path", label,
        "--out", os.path.join(out, "visuals"), "--device", "cuda",
        "--save_correspondences"])
    seconds = time.perf_counter() - t0
    check_ar(result, len(frames))
    for name in ("propagated.mp4", "congealed.mp4", "correspondences.pt"):
        check(os.path.getsize(os.path.join(out, "visuals", name)) > 0,
              f"cli.mixed_reality wrote no {name}")
    print(f"cli.mixed_reality: {len(frames)} PNG frames in {seconds:.2f} s, "
          "videos and correspondences written")


def ar_card_vs_cpu(model, cpu_model, frames, label, label_png):
    """2 frames through each app on the card and on the port's CPU path."""
    x = frames[:2]
    got = ar_run(model, x, label, save_correspondences=True)
    ref = ar_run(cpu_model, x, label, save_correspondences=True)
    with torch.inference_mode():
        flips = [determine_flips(m, torch.from_numpy(x).to(
            next(m.parameters()).device))[1].cpu() for m in (model, cpu_model)]
        both = torch.from_numpy(np.concatenate([x, x[..., ::-1]]))
        flow = cpu_model(both)[2]
    tv = total_variation_loss(flow, reduce_batch=False)
    gap = ((tv[:2] - tv[2:]).abs() / tv[:2]).min()
    pt = float(np.abs(got["correspondences"]
                      - ref["correspondences"]).max())
    cong = float(np.abs(got["congealed"] - ref["congealed"]).max())
    prop = np.abs(got["propagated"] - ref["propagated"])
    print(f"card vs CPU path, AR app on 2 frames: flips {flips[0].ravel()}"
          f" vs {flips[1].ravel()} (smallest relative TV gap {gap:.3e}); "
          f"points {pt:.3e} px, congealed frames {cong:.3e}, propagated "
          f"frames mean {prop.mean():.3e} max {prop.max():.3e}")
    check(torch.equal(flips[0], flips[1]), "AR: the flips differ from the "
          "CPU path")
    check(pt <= AR_PT_TOL, "AR: the points differ from the CPU path")
    check(cong <= OUT_TOL, "AR: the congealed frames differ from the CPU "
          "path")
    check(prop.mean() <= AR_PROP_MEAN_TOL, "AR: the propagated frames "
          "differ from the CPU path")
    got, ref = (images_run(m, x, label_png) for m in (model, cpu_model))
    cong = float(np.abs(got["congealed"] - ref["congealed"]).max())
    prop = np.abs(got["propagated"] - ref["propagated"])
    print(f"card vs CPU path, propagate_to_images on 2 images: congealed "
          f"{cong:.3e}, propagated mean {prop.mean():.3e} max "
          f"{prop.max():.3e}")
    check(cong <= OUT_TOL and prop.mean() <= AR_PROP_MEAN_TOL,
          "propagate_to_images differs from the CPU path")


def hold_pairs(calls, errs, max_sigma=AR_SIGMA):
    """Each recorded K6 launch of the pair, both outputs, against the plain
    pair on the inputs it got."""
    with torch.inference_mode():
        hold("splat", [(o, r) for a, out in calls
                       for o, r in zip(out, splat2d_pair(
                           *a, max_sigma=max_sigma))], errs)


def propagate_object_checks(model, frames, label, k6_args):
    """composed_propagate_object at the path's shapes, with its one K6
    launch held against the plain pair; then the AR path's K6 launch again
    with a quarter of its points moved to -1e6, as that function hides a
    point that leaves the image. Returns the max abs error and the
    launches."""
    dev = next(model.parameters()).device
    points, colors, alphas = (t.to(dev).repeat(AR_BATCH, 1, 1)
                              for t in label)
    points = normalize_points(points, 256, FLAGSHIP.flow_size)
    sigma = torch.full((AR_BATCH,), AR_SIGMA, device=dev)
    errs = {}
    zero_launches()
    with recorded(splat_ops, "splat2d_pair_cuda") as k6, \
            torch.inference_mode():
        obj, mask = composed_propagate_object(
            model, points, colors, alphas,
            torch.from_numpy(frames[:AR_BATCH]).to(dev), sigma,
            max_sigma=AR_SIGMA)
    check(len(k6) == 1 and obj.shape == (AR_BATCH, 3, 256, 256)
          and mask.shape == (AR_BATCH, 1, 256, 256)
          and bool(torch.isfinite(obj).all() & torch.isfinite(mask).all()),
          f"composed_propagate_object launched K6 {len(k6)} times, "
          "expected 1, or its outputs are off")
    hidden = int((k6[0][0][0] == -1e6).all(-1).sum())
    coords, *rest = k6_args
    coords = coords.clone()
    coords[:, ::4] = -1e6
    with recorded(splat_ops, "splat2d_pair_cuda") as k6_hidden:
        splat_ops.splat2d_pair_cuda(coords, *rest)
    hold_pairs(k6 + k6_hidden, errs)
    launches = dict(LAUNCHES)
    print(f"composed_propagate_object at batch {AR_BATCH}, points "
          f"{tuple(points.shape)}: {hidden} of {points.shape[0] * points.shape[1]}"
          f" points hidden at -1e6; the AR path's splat again with "
          f"{AR_BATCH * len(range(0, coords.shape[1], 4))} points hidden: "
          f"K6 max abs err vs plain {errs['splat']:.3e}")
    return errs["splat"], launches


def ar_kernels_vs_plain(k1, k2, k6):
    """Each recorded K1, K2 and K6 launch against its plain version on the
    inputs it got."""
    errs = {}
    with torch.inference_mode():
        hold("mipmap_sample", [(out, _sample_pyramid(*a)) for a, out in k1],
             errs)
        hold("grid_sample", [(out, grid_sample(a[0], a[1],
                                               padding_mode=a[2]))
                             for a, out in k2], errs)
    hold_pairs(k6, errs)
    return errs


def splat_library(coords, obj_values, mask_values, sigma, H, W):
    """The TPU kernel's own formulation of the pair as one PyTorch call:
    torch.bmm of the masked separable weights gy^T (N, H, P) and
    B (N, P, (C + 1) W), each value channel and a channel of ones (alpha)
    times gx, built here, outside the timing (f32, TF32 off). Returns the
    call and the pair's outputs normalised from its result."""
    N, P, Co = obj_values.shape
    values = torch.cat([obj_values, mask_values,
                        torch.ones_like(obj_values[..., :1])], -1)
    C = values.shape[-1] - 1
    x, y = coords[..., 0], coords[..., 1]
    s = sigma[:, None, None]
    visible = ((x >= 0) & (x < W) & (y >= 0) & (y < H)).float()[..., None]

    def weights(c, size):  # (N, P, size)
        idx = torch.arange(size, device=c.device, dtype=c.dtype)
        lo = torch.clamp(torch.floor(c[..., None] - 2.0 * s), min=0)
        hi = torch.clamp(torch.ceil(c[..., None] + 2.0 * s), max=size - 1)
        g = torch.exp(-1.0 / (2.0 * s * s) * (idx - c[..., None]) ** 2)
        return g * ((idx >= lo) & (idx <= hi)).float() * visible

    gyT = weights(y, H).transpose(1, 2).contiguous()
    B = (values[..., None] * weights(x, W)[:, :, None, :]).reshape(
        N, P, (C + 1) * W)

    def call():
        return torch.bmm(gyT, B)

    acc = call().reshape(N, H, C + 1, W).permute(0, 2, 1, 3)
    alpha = acc[:, C:]
    return call, (acc[:, :Co] / (alpha + 1e-8),
                  acc[:, Co:C] / (torch.clamp(alpha, min=1.0) + 1e-8))


def dense_label_args(dev, n=8, size=1024, side=256):
    """A full side x side dense label spread over n images of size x size
    (a point every size / side px, jittered by a quarter of that), with the
    AR path's channels: the large shape that shows the cull's
    O(tiles x points) cost."""
    g = torch.Generator(device=dev).manual_seed(9)
    step = size / side
    ii, jj = torch.meshgrid(torch.arange(side, device=dev),
                            torch.arange(side, device=dev), indexing="ij")
    base = torch.stack([jj, ii], -1).reshape(1, -1, 2).float() * step
    coords = (base + step / 2 + step / 4 * torch.randn(
        n, side * side, 2, device=dev, generator=g)).contiguous()
    obj = torch.rand(n, side * side, 3, device=dev, generator=g) * 2 - 1
    mask = torch.rand(n, side * side, 1, device=dev, generator=g)
    sigma = torch.full((n,), AR_SIGMA, device=dev)
    return coords, obj, mask, sigma, size, size


def toy_pair_args(dev):
    """Two 24 x 20 images, 60 points, some out of the image and at -1e6."""
    g = torch.Generator(device=dev).manual_seed(10)
    coords = (torch.rand(2, 60, 2, device=dev, generator=g)
              * torch.tensor([26.0, 30.0], device=dev) - 3).contiguous()
    coords[0, :4] = -1e6
    obj = torch.randn(2, 60, 3, device=dev, generator=g)
    mask = torch.rand(2, 60, 1, device=dev, generator=g)
    return coords, obj, mask, torch.tensor([1.3, 2.1], device=dev), 24, 20


def splat_checks(path_call, card):
    """K6 off the main path: the toy pair and the general splat2d_cuda on a
    canvas in both normalisations, and the AR path's points at sigma 4,
    whose dense tiles overflow the kernel's shared list, held against the
    plain version; the pair on the AR path's inputs twice, equal to the
    bit to each other and to the path's own launch. Then the device time
    of the pair at the path's shapes beside the two general splats it
    replaces, its plain version, its bound and torch.bmm of the TPU
    kernel's formulation; and of the large dense shape, recorded only.
    Returns the max abs error and the pair's (ms, plain_ms, bound_ms,
    bound_by, library_ms)."""
    errs = {}
    (coords, obj_v, mask_v, sigma, H, W), path_out = path_call
    dev = coords.device
    toy = toy_pair_args(dev)
    with recorded(splat_ops, "splat2d_pair_cuda") as k6:
        splat_ops.splat2d_pair_cuda(*toy)
        splat_ops.splat2d_pair_cuda(coords, obj_v, mask_v,
                                    torch.full_like(sigma, 4.0), H, W)
    hold_pairs(k6[:1], errs, max_sigma=2.1)
    hold_pairs(k6[1:], errs, max_sigma=4.0)
    canvas = torch.randn(2, 3, 24, 20, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(11))
    with torch.inference_mode():
        for soft in (False, True):
            hold("splat", [(splat_ops.splat2d_cuda(canvas, toy[0], toy[1],
                                                   toy[3], soft),
                            splat2d(canvas, toy[0], toy[1], toy[3], soft,
                                    max_sigma=2.1))], errs)
    again = [splat_ops.splat2d_pair_cuda(*path_call[0]) for _ in range(2)]
    check(all(torch.equal(a, b) and torch.equal(a, c)
              for a, b, c in zip(*again, path_out)),
          "K6 gave other bits on the same inputs")
    print(f"K6 held against the plain splat: the toy pair, splat2d_cuda on "
          f"a canvas (both normalisations), the AR path's points at sigma 4 "
          f"(max_sigma 4; its dense tiles overflow the shared list): max abs "
          f"err {errs['splat']:.3e} (tolerance {KERNEL_TOL:g} scaled by "
          f"max(1, max|ref|)); the pair on the AR path's inputs three times: "
          f"equal to the bit")

    args = path_call[0]
    ms = device_ms(lambda: splat_ops.splat2d_pair_cuda(*args), per_call=1)
    singles_ms = device_ms(lambda: (
        splat_ops.splat2d_cuda(torch.zeros_like(path_out[0]), coords, obj_v,
                               sigma),
        splat_ops.splat2d_cuda(torch.zeros_like(path_out[1]), coords, mask_v,
                               sigma, True)), name="splat", per_call=2)
    plain_ms = device_ms(lambda: splat2d_pair(*args, max_sigma=AR_SIGMA))
    b_ms, b_by = splat_bound(coords, sigma, (obj_v, mask_v), path_out)
    library, lib_out = splat_library(*args)
    lib_err = max(scaled_err(o, r)[1] for o, r in zip(lib_out, path_out))
    check(lib_err <= LIBRARY_TOL, f"torch.bmm of the separable weights is "
          f"not K6's function: {lib_err:.3e} scaled")
    library_ms = device_ms(library)
    print(f"K6 pair (object and mask) at the AR path's shapes, "
          f"{tuple(path_out[0].shape)} and {tuple(path_out[1].shape)}, "
          f"points {tuple(coords.shape)}, device time: splat2d_pair_cuda "
          f"(one K6) {ms:.4f} ms; the object and the mask as two "
          f"splat2d_cuda on zeroed canvases, their two K6 {singles_ms:.4f} "
          f"ms; the plain splat2d_pair {plain_ms:.4f} ms; bound {b_ms:.4f} "
          f"ms ({b_by}); "
          f"torch.bmm of gy^T and B (N, P, (C + 1) W) {library_ms:.4f} ms, "
          f"within {lib_err:.3e} of K6 (tolerance {LIBRARY_TOL:g} scaled) "
          f"[{card}]")
    del library, lib_out

    large = dense_label_args(dev)
    with recorded(splat_ops, "splat2d_pair_cuda") as k6_large:
        splat_ops.splat2d_pair_cuda(*large)
    hold_pairs(k6_large, errs)
    large_out = k6_large[0][1]
    large_ms = device_ms(lambda: splat_ops.splat2d_pair_cuda(*large),
                         per_call=1)
    lb_ms, lb_by = splat_bound(large[0], large[3], large[1:3], large_out)
    P = large[0].shape[1]
    print(f"K6 pair on a dense {math.isqrt(P)}^2 label over "
          f"{tuple(large_out[0].shape)}, sigma {AR_SIGMA}, device time: "
          f"{large_ms:.4f} ms, bound {lb_ms:.4f} ms ({lb_by}); max abs err "
          f"vs plain {errs['splat']:.3e} [{card}]")
    return errs["splat"], (ms, plain_ms, b_ms, b_by, library_ms)


def ar(dev, card):
    """The AR object-lens path on the card (phase 5)."""
    d = tempfile.mkdtemp()
    path = os.path.join(d, "stn.pt")
    make_checkpoint(path)
    model, _ = load_stn(path, supersize=256, device=dev)
    cpu_model, _ = load_stn(path, supersize=256, device="cpu")
    label, rgba = synthetic_label()
    P = label[0].shape[1]
    label_png = write_label(rgba, d)
    frames = smooth_images(AR_FRAMES, torch.Generator().manual_seed(8)).numpy()
    print(f"AR label: a disc of radius {LABEL_RADIUS} px, P = {P} points; "
          f"{AR_FRAMES} frames of 256 px at batch {AR_BATCH}")

    # the main path: every launch count starts at 0 here
    zero_launches()
    check_ar(ar_run(model, frames[:AR_BATCH], label), AR_BATCH)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    check_ar(ar_run(model, frames[AR_BATCH:2 * AR_BATCH], label), AR_BATCH)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    seconds = []
    for _ in range(SUBWINDOWS):
        t0 = time.perf_counter()
        result = ar_run(model, frames, label)
        seconds.append(time.perf_counter() - t0)
        check_ar(result, AR_FRAMES)
    rate = AR_FRAMES * SUBWINDOWS / sum(seconds)
    with recorded(mipmap_ops, "mipmap_sample") as k1, \
            recorded(grid_sample_ops, "grid_sample_cuda") as k2, \
            recorded(splat_ops, "splat2d_pair_cuda") as k6, \
            recorded(stn_ops, "sample_grid_at_points") as sampled:
        check_ar(ar_run(model, frames[:AR_BATCH], label), AR_BATCH)
    check(len(k1) == 6 and len(k2) == 1 and len(k6) == 1,
          f"an AR batch launched K1 {len(k1)}, K2 {len(k2)}, K6 {len(k6)} "
          "times; expected 6, 1 and 1")
    errs = ar_kernels_vs_plain(k1, k2, k6)
    view, points = k2[0][0][:2]
    check(len(sampled) == 1
          and view.data_ptr() == sampled[0][0][0].data_ptr()
          and view.is_contiguous(memory_format=torch.channels_last),
          "K2 of an AR batch did not read gridB's own storage")
    with recorded(mipmap_ops, "mipmap_sample") as k1_lap, \
            recorded(grid_sample_ops, "grid_sample_cuda") as k2_lap, \
            recorded(splat_ops, "splat2d_pair_cuda") as k6_lap:
        check_ar(ar_run(model, frames[:AR_BATCH], label,
                        blend_alg="laplacian", overlay_congealed=True),
                 AR_BATCH)
    check(len(k6_lap) == 2, f"the overlay batch launched K6 {len(k6_lap)} "
          "times, expected 2")
    for k, v in ar_kernels_vs_plain(k1_lap, k2_lap, k6_lap).items():
        errs[k] = max(errs[k], v)
    with recorded(mipmap_ops, "mipmap_sample") as k1_img, \
            recorded(grid_sample_ops, "grid_sample_cuda") as k2_img, \
            recorded(splat_ops, "splat2d_pair_cuda") as k6_img:
        check_images(images_run(model, frames[:AR_BATCH], label_png),
                     AR_BATCH)
    check(len(k1_img) == 6 and len(k2_img) == 1 and len(k6_img) == 1,
          f"a propagate_to_images batch launched K1 {len(k1_img)}, K2 "
          f"{len(k2_img)}, K6 {len(k6_img)} times; expected 6, 1 and 1")
    for k, v in ar_kernels_vs_plain(k1_img, k2_img, k6_img).items():
        errs[k] = max(errs[k], v)
    ar_cli(path, frames[:AR_BATCH], label_png, d)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    batches = 6 + SUBWINDOWS * AR_FRAMES // AR_BATCH
    print(f"AR main path: {batches} batches of {AR_BATCH} frames (one of "
          f"them through propagate_to_images); launches {launches}")
    check(launches["mipmap_sample"] == 6 * batches
          and launches["grid_sample"] == batches
          and launches["splat"] == batches + 1
          and sum(launches.values()) == 8 * batches + 1,
          f"the AR path launched {launches}, expected K1 6, K2 1 and K6 1 "
          "a batch and 1 more K6 for the overlay")
    print(f"AR kernel launches held against the plain versions: max abs err "
          f"K1 {errs['mipmap_sample']:.3e}, K2 {errs['grid_sample']:.3e}, K6 "
          f"{errs['splat']:.3e}; K2's inputs {tuple(k2[0][0][0].shape)} "
          f"{tuple(k2[0][0][1].shape)}")
    print(f"AR frames/s: {rate:.1f} over {AR_FRAMES * SUBWINDOWS} frames in "
          f"{sum(seconds):.2f} s (in {SUBWINDOWS} parts: "
          f"{', '.join(f'{AR_FRAMES / t:.1f}' for t in seconds)}), peak "
          f"memory of a batch {peak:.2f} GiB [{card}]")

    k2_ar = k2_times(view, points)
    copy_ms = device_ms(lambda: view.contiguous())
    print_k2(f"of an AR batch (sample_grid_at_points, reading gridB's own "
             f"storage; a contiguous copy of it would take {copy_ms:.4f} ms)",
             view, points, k2_ar, card)
    ar_card_vs_cpu(model, cpu_model, frames, label, label_png)
    err, ar_check_launches = propagate_object_checks(model, frames, label,
                                                     k6[0][0])
    errs["splat"] = max(errs["splat"], err)

    err, splat_times = splat_checks(k6[0], card)
    errs["splat"] = max(errs["splat"], err)

    groups = (("K1 mipmap_sample", ("mipmap_pyramid_fwd",)),
              ("K2 grid_sample", ("grid_sample_kernel",)),
              ("K6 splat", ("splat_tiles",)),
              ("depthwise FIR convs", ("conv_depthwise2d",)),
              CONV_GROUP,
              ("host-device copies", ("memcpy",)),
              ("pads", ("pad",)),
              ("gather and index", ("gather", "index")))
    prof = profiled(lambda: ar_run(model, frames[:2 * AR_BATCH], label))
    print_groups(f"batch of {AR_BATCH} frames in the AR app, 2 batches", 2,
                 *kernel_groups(prof, groups), card, top=4)
    shutil.rmtree(d)
    return (rate, peak, launches, ar_check_launches, errs, splat_times,
            k2_ar[:5])


def main():
    dev, card = setup()
    errs, times, bounds, library = kernels_vs_plain(dev)
    rates, peak_gib, launches, path_err, k1_path = serve(dev, card)
    errs = {k: max(errs[k], path_err[k]) for k in errs}
    train_rate, train_peak, train_launches, check_launches, train_errs, \
        train_times = train(dev, card)
    ar_rate, ar_peak, ar_launches, ar_check_launches, ar_errs, \
        splat_times, k2_ar = ar(dev, card)
    check_launches = {k: check_launches[k] + ar_check_launches[k]
                      for k in LAUNCHES}
    for k, v in list(train_errs.items()) + list(ar_errs.items()):
        errs[k] = max(errs.get(k, 0.0), v)
    for b in BATCHES:
        rate, parts, seconds = rates[b]
        print(f"congeal batch {b}: {rate:.1f} imgs/s over {TIMED[b]} "
              f"requests in {seconds:.2f} s (in {SUBWINDOWS} parts: "
              f"{', '.join(f'{r:.1f}' for r in parts)}), peak memory of a "
              f"request {peak_gib[b]:.2f} GiB [{card}]")
    print(f"train batch {TRAIN_BATCH}: {train_rate:.1f} imgs/s, peak memory "
          f"of a step {train_peak:.2f} GiB [{card}]")
    print(f"AR batch {AR_BATCH}: {ar_rate:.1f} frames/s, peak memory of a "
          f"batch {ar_peak:.2f} GiB [{card}]")
    for name, (ms, plain_ms, call, plain_call) in times.items():
        print(f"{name} at the toy size N=8 C=3 256->128, device time: kernel "
              f"{ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms; time per call: kernel {call:.4f} ms, "
              f"plain {plain_call:.4f} ms; bound {bounds[name][0]:.4f} ms "
              f"({bounds[name][1]}) [{card}]")
    # name: (ms, plain_ms, bound_ms, bound_by, library_ms)
    measured = {k: (v[0], v[1], *bounds[k], library.get(k))
                for k, v in times.items()}
    # K1 on the main path's inputs: a batch-128 forward, per launch
    measured["mipmap_sample"] = k1_path
    measured.update(train_times)
    measured["splat"] = splat_times
    # K2 on the inputs of an AR batch, where most of its main-path
    # launches are
    measured["grid_sample"] = k2_ar
    # "launches" counts the main path only: serve, cli.train and the AR
    # apps, each run with every count zeroed just before it. The backward
    # kernels of the antialias=False form and of an image that needs a
    # gradient run only in the side checks, which count under
    # "check_launches" with the K6 launches of composed_propagate_object's
    # check.
    launches = {k: launches[k] + train_launches[k] + ar_launches[k]
                for k in LAUNCHES}
    for k in MAIN_PATH_KERNELS:
        check(launches[k] > 0, f"{k} was never launched on the main path")
    for k in set(LAUNCHES) - set(MAIN_PATH_KERNELS):
        check(launches[k] == 0 and check_launches[k] > 0,
              f"{k}: {launches[k]} launches on the main path, "
              f"{check_launches[k]} in its check; expected 0 and more")
    for k, (ms, _, bound_ms, *_) in measured.items():
        check(ms >= bound_ms, f"{k} took {ms:.4f} ms, under its bound of "
              f"{bound_ms:.4f} ms: a timing fault")
    print(f"torch.profiler: {WINDOWS['taken']} windows, "
          f"{WINDOWS['retaken']} of them taken again for a missed kernel")
    print(card)
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": launches[name], "check_launches": check_launches[name],
         "max_abs_err": errs[name], **dict(zip(keys, measured[name]))}
        for name, (src, tpu) in KERNEL_INFO.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
