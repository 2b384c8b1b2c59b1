"""Smoke run of gangealing_torch on one CUDA card: build the kernels, hold
them against their plain PyTorch versions, serve the flagship ComposedSTN
congeal forward through them, and train the flagship GANgealing
configuration through them.

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
     at 40), batch-4 forwards with and without anti-aliasing held against
     the port's CPU path (out 5e-4, grid and flow 1e-4), and the device
     time of a few forwards by kernel group with the idle share;
  4. training, the reference's LSUN-cats run (scripts/training/
     lsun_cats_ssl.sh: 256px StyleGAN2 with 512-dim latents and 8 mapping
     layers, the flagship STN, vgg_ssl, tv_weight 1000, border padding,
     batch 40) with seeded random G and VGG: python -m
     gangealing_torch.cli.train for 4 iterations (1M-latent PCA cold
     start, checkpoints at 2 and 4, scalars finite, the last checkpoint
     resumed), K1 and K3 twice per step and K5a never; the perceptual term
     alone reaching the identity-initialised similarity head; each K1 and
     K3 launch of a step from the trained state and of one from the
     identity init, each K2 and K4 launch of an antialias=False step and
     each K5a and K5b launch of a forward whose input needs a gradient held
     against the plain versions and their autograd (1e-5 scaled by
     max(1, max|ref|)); train imgs/s over about 5 s and the peak memory of
     a step; the device time of a step by kernel group with the idle
     share; and one step's loss and gradients on the card against the
     port's CPU path at batch 2, from the trained state and from the
     identity init (TRAIN_GRAD_TOL, TRAIN_GRAD_L2_TOL);
  5. imgs/s, and each kernel's device time (torch.profiler) beside its
     plain version's, each beside the card; the kernels line, whose
     "launches" are the main path's (serve and cli.train) and whose
     "check_launches" are the side checks' (the antialias=False step and
     the forward whose input needs a gradient).

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

import torch

from gangealing_torch import LAUNCHES, _build
from gangealing_torch.apps.common import load_stn
from gangealing_torch.cli import train as train_cli
from gangealing_torch.models.latent_learner import LatentLearner
from gangealing_torch.models.lpips import make_perceptual_loss
from gangealing_torch.models.stn import ComposedSTN, ComposedSTNConfig
from gangealing_torch.models.stylegan2 import Generator, GeneratorConfig
from gangealing_torch.ops import grid_sample as grid_sample_ops
from gangealing_torch.ops import mipmap as mipmap_ops
from gangealing_torch.ops.flow import total_variation_loss
from gangealing_torch.ops.grid_sample import (
    affine_grid, grid_sample, grid_sample_auto, grid_sample_cuda)
from gangealing_torch.ops.mipmap import (
    _build_stack, _mipmap_warp_fold, _sample_stack, mipmap_levels,
    mipmap_sample, mipmap_warp)
from gangealing_torch.ops.resample import interpolate_bilinear
from gangealing_torch.train import checkpoint as train_ckpt
from gangealing_torch.train.losses import gangealing_loss
from gangealing_torch.train.state import TrainState, train_step

PADDINGS = ("border", "reflection", "zeros")
KERNEL_TOL = 1e-5
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
    "mipmap_sample_dstack": ("gangealing_torch/csrc/mipmap_sample.cu",
                             "gangealing_tpu/ops/pallas_mipmap.py:105"),
    "grid_sample_dimg": ("gangealing_torch/csrc/grid_sample.cu",
                         "gangealing_tpu/ops/pallas_grid_sample.py:64"),
}


# The kernels the main path launches: K1 and K2 in serve (K2 in its
# antialias=False forward), K1 and K3 in every train step.
MAIN_PATH_KERNELS = ("mipmap_sample", "grid_sample", "mipmap_sample_dcoords")


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


def device_ms(fn, iters=20):
    """Device time per call of ``fn`` in ms: the summed time of the kernels
    one call launches, from torch.profiler over ``iters`` calls."""
    fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    check(us > 0, "the profiler saw no device time")
    return us / 1e3 / iters


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
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {line.strip()}")
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0), card


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
    stack = torch.stack(_build_stack(img, 4), dim=1)
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
        "mipmap_sample": (lambda: mipmap_sample(stack, grid, levels),
                          lambda: _sample_stack(stack, grid, levels, "border")),
        "grid_sample": (lambda: grid_sample_cuda(img, grid),
                        lambda: grid_sample(img, grid)),
    }
    # device time of the kernel(s) and time per call, kernel then plain
    times = {name: (device_ms(k), device_ms(p), call_ms(k), call_ms(p))
             for name, (k, p) in calls.items()}
    return errs, times


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

    def record(*args):
        out = fn(*args)
        calls.append((args, out))
        return out

    setattr(module, name, record)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def kernels_at_path_shapes(model, no_aa, requests):
    """Each kernel launch of one served forward against its plain version on
    the very inputs the forward gave it: K1 in both heads at batch 40 and
    128, K2 in both heads of the antialias=False forward at batch 40."""
    def plain_k2(img, grid, padding_mode):
        return grid_sample(img, grid, padding_mode=padding_mode)

    cases = [("mipmap_sample", mipmap_ops, "mipmap_sample", _sample_stack,
              model, b) for b in BATCHES]
    cases.append(("grid_sample", grid_sample_ops, "grid_sample_cuda",
                  plain_k2, no_aa, 40))
    err = {"mipmap_sample": 0.0, "grid_sample": 0.0}
    for name, module, entry, plain, m, b in cases:
        with recorded(module, entry) as calls:
            check_outputs(congeal(m, requests[b][0]), b)
        check(len(calls) == 2, f"{name}: {len(calls)} launches in one "
              "forward, expected 2")
        for head, (args, out) in zip(("similarity", "flow"), calls):
            with torch.inference_mode():
                e = float((out - plain(*args)).abs().max())
            shapes = " ".join(str(tuple(a.shape)) for a in args[:-1])
            print(f"{name} in the {head} head at batch {b}, inputs {shapes}: "
                  f"max abs err vs plain {e:.3e}")
            check(e <= KERNEL_TOL, f"{name} disagrees with its plain version "
                  f"in the {head} head at batch {b}")
            err[name] = max(err[name], e)
    return err


def kernel_groups(prof, groups):
    """Device time by kernel group of a torch.profiler run, its busy time,
    the span from the first kernel's start to the last one's end, and the
    time of each kernel name that fell in no group."""
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
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
    groups = (("K1 mipmap_sample", ("mipmap_sample",)),
              ("K2 grid_sample", ("grid_sample_kernel",)),
              ("depthwise FIR convs", ("conv_depthwise2d",)),
              CONV_GROUP,
              ("pads", ("pad",)),
              ("gather and index", ("gather", "index")))
    for b in BATCHES:
        congeal(model, requests[b][0])
        torch.cuda.synchronize()
        activities = [torch.profiler.ProfilerActivity.CPU,
                      torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            for i in range(PROFILED):
                congeal(model, requests[b][i % REQUESTS])
            torch.cuda.synchronize()
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

    path_err = kernels_at_path_shapes(model, no_aa, requests)
    g4 = torch.Generator().manual_seed(2)
    card_vs_cpu(model, cpu_model,
                torch.rand(4, 3, 256, 256, generator=g4) * 2 - 1,
                "antialiased forward, noise images")
    card_vs_cpu(no_aa, cpu_no_aa, smooth_images(4, g4),
                "antialias=False forward, smooth images")
    where_time_goes(model, requests, card)
    return rates, peak_gib, launches, path_err


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
    stack, grid, levels, dout, pm = a
    g = grid.detach().requires_grad_()
    lv = levels.detach().requires_grad_()
    return _sample_stack(stack, g, lv, pm), (g, lv), dout


def k4_graph(a):
    img, grid, dout, pm = a
    g = grid.detach().requires_grad_()
    return grid_sample(img, g, padding_mode=pm), (g,), dout


def k5a_graph(a):
    grid, levels, dout, stack_shape, pm = a
    s = torch.zeros(stack_shape, device=grid.device, requires_grad=True)
    return _sample_stack(s, grid, levels, pm), (s,), dout


def k5b_graph(a):
    grid, dout, input_shape, pm = a
    x = torch.zeros(input_shape, device=grid.device, requires_grad=True)
    return grid_sample(x, grid, padding_mode=pm), (x,), dout


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
    inputs, and of the plain version's backward (its graph built once)."""
    args, _ = calls[0]
    plain_out, inputs, dout = graph_of(args)
    return (device_ms(lambda: kernel(*args)),
            device_ms(lambda: torch.autograd.grad(plain_out, inputs, dout,
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
    check(launches["mipmap_sample_dstack"] == 0,
          "K5a launched for a stack that needs no gradient")
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
                recorded(mipmap_ops, "mipmap_sample_dcoords") as k3:
            step(st)
        check(len(k1) == 2 and len(k3) == 2, f"a step from the {what} did "
              "not launch K1 and K3 twice")
        if what == "trained state":
            k3_trained = k3
        step_errs = {}
        with torch.no_grad():
            hold("mipmap_sample", [(out, _sample_stack(*a)) for a, out in k1],
                 step_errs)
        hold("mipmap_sample_dcoords", backward_pairs(k3, k3_graph), step_errs)
        for k, v in step_errs.items():
            errs[k] = max(errs.get(k, 0.0), v)
        print(f"K1 and K3 launches of a train step from the {what}, inputs "
              f"{tuple(k3[0][0][0].shape)} {tuple(k3[0][0][1].shape)}: max "
              f"abs err K1 {step_errs['mipmap_sample']:.3e}, K3 "
              f"{step_errs['mipmap_sample_dcoords']:.3e}")
    k3 = k3_trained

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
    with recorded(mipmap_ops, "mipmap_sample_dstack") as k5a, \
            recorded(grid_sample_ops, "grid_sample_dimg") as k5b:
        loss = ((state.t(x)[0] + t_no_aa(x)[0]) * cot).sum()
        loss.backward()
    torch.cuda.synchronize()
    image_launches = dict(LAUNCHES)
    check(image_launches["mipmap_sample_dstack"] == 2
          and image_launches["grid_sample_dimg"] == 2,
          f"a forward with an input that needs a gradient launched "
          f"{image_launches}")
    hold("mipmap_sample_dstack", backward_pairs(k5a, k5a_graph), errs)
    hold("grid_sample_dimg", backward_pairs(k5b, k5b_graph), errs)
    print(f"K2 and K4 launches of an antialias=False step, K5a and K5b of a "
          f"forward whose input needs a gradient: max abs err K2 "
          f"{errs['grid_sample']:.3e}, K4 {errs['grid_sample_dgrid']:.3e}, "
          f"K5a {errs['mipmap_sample_dstack']:.3e}, K5b "
          f"{errs['grid_sample_dimg']:.3e}")

    times = {
        "mipmap_sample_dcoords": backward_times(
            k3, k3_graph, mipmap_ops.mipmap_sample_dcoords),
        "grid_sample_dgrid": backward_times(
            k4, k4_graph, grid_sample_ops.grid_sample_dgrid),
        "mipmap_sample_dstack": backward_times(
            k5a, k5a_graph, mipmap_ops.mipmap_sample_dstack),
        "grid_sample_dimg": backward_times(
            k5b, k5b_graph, grid_sample_ops.grid_sample_dimg),
    }
    for name, (ms_k, ms_p) in times.items():
        print(f"{name} at the train step's shapes, device time: kernel "
              f"{ms_k:.4f} ms, plain autograd {ms_p:.4f} ms [{card}]")

    groups = (("K1 mipmap_sample", ("mipmap_sample_kernel",)),
              ("K3 mipmap d/dcoords", ("mipmap_dcoords_kernel",)),
              ("depthwise FIR convs", ("conv_depthwise2d",)),
              CONV_GROUP,
              ("Adam and EMA (multi-tensor)", ("multi_tensor",)),
              ("reductions", ("reduce",)),
              ("pads", ("pad",)),
              ("gather, scatter and index", ("gather", "scatter", "index")))
    step()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(2):
            step()
        torch.cuda.synchronize()
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


def main():
    dev, card = setup()
    errs, times = kernels_vs_plain(dev)
    rates, peak_gib, launches, path_err = serve(dev, card)
    errs = {k: max(errs[k], path_err[k]) for k in errs}
    train_rate, train_peak, train_launches, check_launches, train_errs, \
        train_times = train(dev, card)
    for k, v in train_errs.items():
        errs[k] = max(errs.get(k, 0.0), v)
    for b in BATCHES:
        rate, parts, seconds = rates[b]
        print(f"congeal batch {b}: {rate:.1f} imgs/s over {TIMED[b]} "
              f"requests in {seconds:.2f} s (in {SUBWINDOWS} parts: "
              f"{', '.join(f'{r:.1f}' for r in parts)}), peak memory of a "
              f"request {peak_gib[b]:.2f} GiB [{card}]")
    print(f"train batch {TRAIN_BATCH}: {train_rate:.1f} imgs/s, peak memory "
          f"of a step {train_peak:.2f} GiB [{card}]")
    for name, (ms, plain_ms, call, plain_call) in times.items():
        print(f"{name} at N=8 C=3 256->128, device time: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms; time per call: kernel {call:.4f} ms, "
              f"plain {plain_call:.4f} ms [{card}]")
    device_times = {k: v[:2] for k, v in times.items()}
    device_times.update(train_times)
    # "launches" counts the main path only: serve and cli.train, each run
    # with every count zeroed just before it. The backward kernels of the
    # antialias=False form and of an image that needs a gradient run only in
    # the side checks, which count under "check_launches".
    launches = {k: launches[k] + train_launches[k] for k in LAUNCHES}
    for k in MAIN_PATH_KERNELS:
        check(launches[k] > 0, f"{k} was never launched on the main path")
    for k in set(LAUNCHES) - set(MAIN_PATH_KERNELS):
        check(launches[k] == 0 and check_launches[k] > 0,
              f"{k}: {launches[k]} launches on the main path, "
              f"{check_launches[k]} in its check; expected 0 and more")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": launches[name], "check_launches": check_launches[name],
         "max_abs_err": errs[name], "ms": device_times[name][0],
         "plain_ms": device_times[name][1]}
        for name, (src, tpu) in KERNEL_INFO.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
