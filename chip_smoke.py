"""Smoke run of gangealing_torch on one CUDA card: build the kernels, hold
them against their plain PyTorch versions, and serve the flagship ComposedSTN
congeal forward through them.

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
  4. imgs/s, and each kernel's device time (torch.profiler) and time per
     call (CUDA events) beside its plain version's, each beside the card.

Any failure raises and the exit code is not 0. The last line of standard
output is the JSON result {"ok": true, "device": {...}}.
"""

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

from gangealing_torch import LAUNCHES, _build
from gangealing_torch.apps.common import load_stn
from gangealing_torch.models.stn import ComposedSTN, ComposedSTNConfig
from gangealing_torch.ops import grid_sample as grid_sample_ops
from gangealing_torch.ops import mipmap as mipmap_ops
from gangealing_torch.ops.flow import total_variation_loss
from gangealing_torch.ops.grid_sample import (
    affine_grid, grid_sample, grid_sample_auto, grid_sample_cuda)
from gangealing_torch.ops.mipmap import (
    _build_stack, _mipmap_warp_fold, _sample_stack, mipmap_levels,
    mipmap_sample, mipmap_warp)
from gangealing_torch.ops.resample import interpolate_bilinear

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


def where_time_goes(model, requests, card):
    """Device time of PROFILED forwards per batch size under torch.profiler,
    by kernel group, and the device's idle share: the part of the span from
    the first kernel's start to the last kernel's end in which no kernel
    ran (one stream, so kernels do not overlap)."""
    groups = (("K1 mipmap_sample", ("mipmap_sample",)),
              ("K2 grid_sample", ("grid_sample_kernel",)),
              ("depthwise FIR convs", ("conv_depthwise2d",)),
              ("cuDNN convs and GEMMs", ("xmma", "gemm", "fft", "complex",
                                         "cudnn", "cutlass", "sm80_",
                                         "sm90_")),
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
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        check(kernels, "the profiler saw no device activity")
        by_group = {}
        for e in kernels:
            name = e.name.lower()
            group = next((g for g, keys in groups
                          if any(k in name for k in keys)),
                         "elementwise and other")
            us = e.time_range.elapsed_us()
            by_group[group] = by_group.get(group, 0.0) + us
        busy = sum(by_group.values())
        span = (max(e.time_range.end for e in kernels)
                - min(e.time_range.start for e in kernels))
        print(f"where the time goes, batch {b}, {PROFILED} forwards: device "
              f"busy {busy / 1e3:.3f} of {span / 1e3:.3f} ms, idle share "
              f"{1 - busy / span:.4f} [{card}]")
        for group, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
            print(f"  {group}: {us / 1e3 / PROFILED:.3f} ms per forward "
                  f"({us / busy:.2%})")


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
    for k in LAUNCHES:
        LAUNCHES[k] = 0
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
        ms = []
        for w in range(SUBWINDOWS):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            results = [congeal(model, requests[b][(w * part + i) % REQUESTS])
                       for i in range(part)]
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
            for r in results:
                check_outputs(r, b)
            forwards += part
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


def main():
    dev, card = setup()
    errs, times = kernels_vs_plain(dev)
    rates, peak_gib, launches, path_err = serve(dev, card)
    errs = {k: max(errs[k], path_err[k]) for k in errs}
    for b in BATCHES:
        rate, parts, seconds = rates[b]
        print(f"congeal batch {b}: {rate:.1f} imgs/s over {TIMED[b]} "
              f"requests in {seconds:.2f} s (in {SUBWINDOWS} parts: "
              f"{', '.join(f'{r:.1f}' for r in parts)}), peak memory of a "
              f"request {peak_gib[b]:.2f} GiB [{card}]")
    for name, (ms, plain_ms, call, plain_call) in times.items():
        print(f"{name} at N=8 C=3 256->128, device time: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms; time per call: kernel {call:.4f} ms, "
              f"plain {plain_call:.4f} ms [{card}]")
    print(json.dumps({"kernels": [
        {"name": "mipmap_sample", "route": "cuda",
         "source": "gangealing_torch/csrc/mipmap_sample.cu",
         "replaces": "gangealing_tpu/ops/pallas_mipmap.py:84",
         "launches": launches["mipmap_sample"],
         "max_abs_err": errs["mipmap_sample"],
         "ms": times["mipmap_sample"][0],
         "plain_ms": times["mipmap_sample"][1]},
        {"name": "grid_sample", "route": "cuda",
         "source": "gangealing_torch/csrc/grid_sample.cu",
         "replaces": "gangealing_tpu/ops/pallas_grid_sample.py:41",
         "launches": launches["grid_sample"],
         "max_abs_err": errs["grid_sample"],
         "ms": times["grid_sample"][0],
         "plain_ms": times["grid_sample"][1]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
