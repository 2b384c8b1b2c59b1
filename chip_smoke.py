"""Smoke run of gangealing_torch on one CUDA card: build the kernels, hold
them against their plain PyTorch versions, serve the flagship ComposedSTN
congeal forward through them, train the flagship GANgealing configuration
through them with its visuals and a profiler window, and run the AR
object-lens app and the eval apps (PCK-Transfer, flow scores,
congeal_dataset and their CLIs, on LMDB datasets) through them; then train
the LSUN-cars clustering configuration with its cluster visuals and its
cluster classifier and run the AR apps with that classifier; then render
the correspondence videos (vis_correspondence) and turn a video into an
LMDB (process_video); then train both configurations and serve the
flagship with --compute_dtype bfloat16.

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
     resumed), K1 and K3 twice per step and K5a never, its visuals at 0, 2
     and 4 (n_sample 64, vis_batch_size 250, n_mean cut to 200 over an
     LMDB of 200 synthetic 256 px reals; 6 K1 a call), each grid's PNG
     by name, animate_visuals' mp4, and a torch.profiler window over
     steps (1, 3] whose Chrome trace holds K1 and K3 kernels; one vis call
     timed with its peak memory, one split into decode, G, the STN,
     flow colouring and PNG encode with its K1 launches held against the
     plain version, and one at batch 2 on the card (cuDNN's convolutions,
     as cli.train runs them) against the CPU path (the arrays of the
     grids 5e-4, the coloured flows one uint8 level); the perceptual term
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
     port's CPU path at batch 2, from the state cli.train wrote and from
     the identity init (TRAIN_GRAD_TOL, TRAIN_GRAD_L2_TOL), as are the
     K1 and K3 launches of the trained state; and from both states the
     same step in bfloat16 on the card against the CPU path (BF16_GATES:
     loss terms and L2 held, the worst tensor printed beside its gate)
     and against the card's float32 step (BF16_VS_F32);
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
  6. the eval path with the flagship STN loaded through load_stn: 400
     smooth 256 px images written as PNGs into an LMDB by the port's
     write_lmdb (read back by its native reader, which must be the one that
     ran) with SPair-shaped sidecars (200 fixed pairs, 15 key points with
     visibility, thresholds, inverse transforms, a left-right
     permutation); PCK-Transfer at the shape of the JAX package's
     bench.py::bench_pck (iters 3, the 4-way flip match, both ways, alphas
     0.1, 0.05 and 0.01) at the eval batch of 50: a warm-up batch, pairs/s
     by host clock over the 200 pairs with the decode, the peak memory,
     two batches' device time by kernel group with the idle share, one
     batch with its 20 K1 and 2 K2 launches held against the plain
     versions; flow scores over the 400 images (imgs/s, peak, idle share)
     and filter_dataset at 0.5; congeal_dataset over 64 images at the
     CLI's defaults (imgs/s, accepted count); cli.pck (with
     --vis_transfer), cli.flow_scores, cli.congeal_dataset,
     cli.prepare_data and cli.propagate_to_images (with --flow_scores, its
     K6 launch held against the plain pair) once each on small inputs;
     then the card against the port's CPU path on 2 pairs and 4 images:
     equal match picks, transferred points within 0.05 px (an inversion
     pick may differ only at a near tie of the CPU path's distances, which
     is counted), equal PCK counts, flow scores within 1e-4 relative,
     equal congeal_dataset decisions, aligned images within 5e-4 with
     the card's native convolutions (cuDNN's reading printed beside it);
  7. the cluster phase: the reference's LSUN-cars run
     (scripts/training/lsun_cars.sh: 4 heads and flips, 5 directions,
     inject 6, G's 256 px image sampled with reflection padding, tv_weight
     2500, lpips; the cats run's widths) at CARS_BATCH with seeded random
     G, STN and LPIPS: python -m gangealing_torch.cli.train for 2
     iterations with --debug (the cold start's PCA on 1000 latents, its
     centroids the first 4) and the recipe's --vis_every 5000 (the cluster
     visuals at its start over the 200 reals, n_mean 200, 4 chunks of 62
     fakes: 18 K1; timed, peak memory, each head's grids), K1 and K3
     twice a step, imgs/s over 8 steps
     in 4 parts, the peak memory of a step, each K1 and K3 launch of a step
     held against the plain versions and timed beside them, their bounds
     (reflected taps) and F.grid_sample on the volume, the pyramid's build
     on the 2NK repeated sources against the 2N distinct ones, the device
     time of a step by kernel group with the idle share, and one clustered
     step at batch 2 from the state cli.train wrote, on the card against
     the port's CPU path (equal assignments, a difference at a near tie of
     the distances counted and the step taken again with the next z; loss
     terms 1e-4 relative, TRAIN_GRAD_TOL, TRAIN_GRAD_L2_TOL); python -m
     gangealing_torch.cli.train_cluster_classifier on the cars checkpoint
     (lsun_cars_cluster_classifier.sh: 8 logits, warm-started from the
     STN's EMA) at CLS_BATCH, its imgs/s and peak, classifier.pt loaded
     back through
     load_stn(load_classifier=True), one step at batch 2 on the card
     against the CPU path (equal labels, cross-entropy 1e-4 relative);
     one K-Means++ of 4 centroids over KMEANS_LATENTS latents, timed; the
     AR apps with the classifier (each frame through its one head): frames/s
     at batch 50, a batch with the cluster-activity video (average.mp4),
     propagate_to_images with and without a cluster, K1 4, K2 1 and K6 1
     a batch held against the plain versions, and 2 frames on the card
     against the CPU path (equal clusters and flips, the AR gates);
  8. the visualize phase: python -m gangealing_torch.cli.vis_correspondence
     in track mode with the flagship through load_stn, 4 of the reals, a
     fully opaque 256 px RGBA label (P = 65,536), --length 60,
     --vis_in_stages, --stage_flip and --objects: its three mp4s, frames/s,
     each stage's seconds and launches, every K1, K2 and K6 launch held
     against its plain version (K6's over-full tile lists included), one
     tracked stage under torch.profiler (the idle share); a 4-frame track
     of 2 images with a disc label on the card against the CPU path
     (congealing frames within one uint8 level, the patch searches equal
     but at near ties, counted); --mode congeal, propagate and average
     once; python -m gangealing_torch.cli.process_video on 32 frames of
     256 px, read back, and its work split into decode, crop, PNG encode
     and the LMDB's write;
  9. the precision phase (chip_smoke.py::precision): python -m
     gangealing_torch.cli.train --compute_dtype bfloat16 (G's synthesis
     and the perceptual trunk in bfloat16) on the cats flags at
     TRAIN_BATCH and the cars flags at CARS_BATCH for BF16_ITERS
     iterations each: K1 and K3 twice a step on float32 operands, held
     against the plain versions, finite scalars, the last checkpoint
     resumed; imgs/s over about 5 s in 4 parts and the peak memory
     beside this run's float32 figures, the cats step's device time by
     kernel group with the idle share; a batch-2 clustered bfloat16 step on the card
     against the CPU path (BF16_CLUSTER_GATES, equal assignments but at
     near ties of BF16_TIE, counted) and against the card's float32
     step (printed); the flagship congeal forward with its encoders in
     bfloat16 at batch 128: its two K1 launches held, its grids and
     flows against the float32 forward's (BF16_CONGEAL_TOL), imgs/s and
     its peak;
 10. rates, and each kernel's device time (torch.profiler; K6's by CUDA
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
     "launches" are the main path's (serve, cli.train, the AR apps, the
     eval apps, the cluster phase, the visualize phase and the precision
     phase) and
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
from gangealing_torch.apps import congeal_dataset as congeal_app
from gangealing_torch.apps import flow_scores as flow_app
from gangealing_torch.apps import pck as pck_app
from gangealing_torch.apps import vis_correspondence as vc_app
from gangealing_torch.apps.common import determine_flips, load_stn
from gangealing_torch.apps.mixed_reality import run_gangealing_on_video
from gangealing_torch.apps.propagate_to_images import propagate_to_images
from gangealing_torch.cli import congeal_dataset as congeal_dataset_cli
from gangealing_torch.cli import flow_scores as flow_scores_cli
from gangealing_torch.cli import mixed_reality as mixed_reality_cli
from gangealing_torch.cli import pck as pck_cli
from gangealing_torch.cli import prepare_data as prepare_data_cli
from gangealing_torch.cli import process_video as process_video_cli
from gangealing_torch.cli import propagate_to_images as propagate_cli
from gangealing_torch.cli import train as train_cli
from gangealing_torch.cli import train_cluster_classifier as cls_cli
from gangealing_torch.cli import vis_correspondence as vis_cli
from gangealing_torch.data.dataset import (
    DataLoader, MultiResolutionDataset, PCKDataset)
from gangealing_torch.data.lmdb_io import LMDBReader, write_lmdb
from gangealing_torch.data.prepare import SPAIR_PERMUTATIONS, center_crop
from gangealing_torch.models.latent_learner import LatentLearner
from gangealing_torch.models.layers import dtype_of
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
from gangealing_torch.train import loop as train_loop
from gangealing_torch.train.classifier_train import ClassifierTrainer
from gangealing_torch.train.clustering import kmeans_plusplus
from gangealing_torch.train.losses import (
    assign_fake_images_to_clusters, gangealing_loss)
from gangealing_torch.train.state import TrainState, train_step
from gangealing_torch.train import visuals as visuals_mod
from gangealing_torch.train.visuals import (
    GANgealingWriter, animate_visuals, create_training_visuals)

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
# antialias=False forward), K1 and K3 in every train step (the cars step's
# too), K1 in every training vis call (6 a cats call, 18 a cars call), K1,
# K2 and K6 in every batch of the AR app (with the classifier too), K1 and
# K2 in every PCK batch, K6 in cli.propagate_to_images, K1 in every
# classifier step, and in cli.vis_correspondence's track K1 in every frame
# of a stage, K2 once and K6 in the flip's splat and each chunk of
# splat_batch frames.
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
    pyramid stores it. C float32 values each. Border padding clamps the
    taps into the image, reflection padding reflects them into it, zeros
    padding drops those outside it."""
    N, C, H, W = image_shape
    size = 2 ** math.ceil(math.log2(W))
    lp = (size - W) // 2
    D = 4
    # the padding rule of the samplers: clamped (border), reflected into
    # the image and clamped (reflection), or left outside (zeros)
    ix = grid_sample_ops._compute_coords(grid[..., 0], W, padding_mode,
                                         False)
    iy = grid_sample_ops._compute_coords(grid[..., 1], H, padding_mode,
                                         False)
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
STEP_GROUPS = (("K1 mipmap_sample", ("mipmap_pyramid_fwd",)),
               ("K3 mipmap d/dcoords", ("mipmap_pyramid_dcoords",)),
               ("depthwise FIR convs", ("conv_depthwise2d",)),
               CONV_GROUP,
               ("Adam and EMA (multi-tensor)", ("multi_tensor",)),
               ("reductions", ("reduce",)),
               ("pads", ("pad",)),
               ("gather, scatter and index", ("gather", "scatter", "index")))


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


# The training visuals: the recipes' n_sample (64) and vis_batch_size (250,
# 62 a head in the cars run), n_mean cut from 8,000 to VIS_REALS as --debug
# cuts it, over an LMDB of VIS_REALS smooth 256 px images; the cats run
# draws them every VIS_EVERY iterations (and at its start) and traces its
# steps (PROFILE_WINDOW] with torch.profiler; the cars run takes the
# recipe's --vis_every 5000, so draws them at its start. A vis call's
# share is of the VIS_CYCLE iterations between two of them at this run's
# imgs/s. The PNG grids of a cats vis call, by name.
VIS_REALS = 200
VIS_SAMPLES = 64
VIS_BATCH = 250
VIS_EVERY = 2
PROFILE_WINDOW = (1, 3)
VIS_CYCLE = 5000
CATS_GRIDS = ("sample", "mean_sample", "transformed_sample",
              "mean_transformed_sample", "truncated_sample",
              "mean_truncated_sample", "mean_EMA_transformed_real_sample",
              "EMA_transformed_real_sample", "flow_real")
# a colour-coded flow is floored to uint8 levels: flows within GRID_TOL may
# land a level apart
FLOW_RGB_TOL = 1.0 / 255 + 1e-6


def real_lmdb(path):
    """VIS_REALS smooth 256 px images as an LMDB of PNGs: the real images
    of the training visuals and of the visualize phase."""
    return image_lmdb(path, smooth_images(
        VIS_REALS, torch.Generator().manual_seed(21)).numpy())


def cats_argv(results, gpath, iters, *extra):
    """The reference's LSUN-cats run (scripts/training/lsun_cats_ssl.sh) on
    one card at the global batch of 40 for ``iters`` iterations, a
    checkpoint every 2."""
    return ["--exp-name", "smoke", "--results", results, "--ckpt", gpath,
            "--load_G_only", "--padding_mode", "border", "--tv_weight", "1000",
            "--loss_fn", "vgg_ssl", "--ndirs", "1", "--inject", "5",
            "--gen_size", "256", "--dim_latent", "512", "--n_mlp", "8",
            "--gen_channel_multiplier", "2", "--flow_size", "128",
            "--stn_channel_multiplier", "0.5", "--real_size", "256",
            "--batch", str(TRAIN_BATCH), "--iter", str(iters),
            "--ckpt_every", "2", "--log_every", "1", *extra]


def train_argv(results, gpath, reals, trace_dir):
    """The cats run for TRAIN_ITERS iterations with its visuals every
    VIS_EVERY and a profiler window."""
    return cats_argv(
        results, gpath, TRAIN_ITERS, "--vis_every", str(VIS_EVERY),
        "--real_data_path", reals, "--n_mean", str(VIS_REALS),
        "--n_sample", str(VIS_SAMPLES), "--vis_batch_size", str(VIS_BATCH),
        "--profile_dir", trace_dir, "--profile_start",
        str(PROFILE_WINDOW[0]), "--profile_stop", str(PROFILE_WINDOW[1]))


@contextlib.contextmanager
def vis_calls(name, itr_index):
    """Time each call of the training loop's visuals function ``name`` made
    in the block, the card synchronised at both ends. Records (iteration,
    seconds, peak GiB from its start, its K1 launches) a call."""
    fn = getattr(train_loop, name)
    calls = []

    def timed(*a, **kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k1 = LAUNCHES["mipmap_sample"]
        t0 = time.perf_counter()
        fn(*a, **kw)
        torch.cuda.synchronize()
        calls.append((a[itr_index], time.perf_counter() - t0,
                      torch.cuda.max_memory_allocated() / 2 ** 30,
                      LAUNCHES["mipmap_sample"] - k1))

    setattr(train_loop, name, timed)
    try:
        yield calls
    finally:
        setattr(train_loop, name, fn)


def check_grids(run_dir, names, itrs):
    pngs = set(os.listdir(run_dir))
    missing = [f"{n}_{str(i).zfill(7)}.png" for n in names for i in itrs
               if f"{n}_{str(i).zfill(7)}.png" not in pngs]
    check(not missing, f"the visuals wrote no {missing[:4]}")


def trace_kernels(trace_dir):
    """The kernel events of the one Chrome trace in ``trace_dir``, counted
    by name: K1's and K3's, and all."""
    files = os.listdir(trace_dir)
    check(len(files) == 1 and files[0].endswith(".json"),
          f"the profiler window wrote {files}")
    with open(os.path.join(trace_dir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    return ({k: sum(k in n for n in names)
             for k in ("mipmap_pyramid_fwd", "mipmap_pyramid_dcoords")},
            len(names), os.path.getsize(os.path.join(trace_dir, files[0])))


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


def cli_run(dev, reals):
    """python -m gangealing_torch.cli.train in process, from a seeded random
    G saved in the reference schema, with its visuals and a profiler
    window; then the scalars, the PNG grids, their animation, the trace's
    kernels and the last checkpoint, resumed into a fresh state."""
    d = tempfile.mkdtemp()
    gpath = os.path.join(d, "g.pt")
    gen = Generator(GeneratorConfig(), generator=torch.Generator().manual_seed(3))
    torch.save({"g_ema": gen.state_dict()}, gpath)
    del gen
    trace_dir = os.path.join(d, "trace")
    zero_launches()
    t0 = time.perf_counter()
    with vis_calls("create_training_visuals", 9) as vis:
        state, generator, perceptual, pfn = train_cli.main(
            train_argv(os.path.join(d, "results"), gpath, reals, trace_dir))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    vis_k1 = sum(c[3] for c in vis)
    print(f"cli.train: {TRAIN_ITERS} iterations at batch {TRAIN_BATCH} with "
          f"the cold start in {seconds:.1f} s; launches {launches}; visuals "
          f"at iterations {[c[0] for c in vis]} in "
          f"{', '.join(f'{c[1]:.2f}' for c in vis)} s, K1 {vis_k1}")
    check([c[0] for c in vis] == list(range(0, TRAIN_ITERS + 1, VIS_EVERY)),
          "the visuals ran at the wrong iterations")
    # a vis call: two K1 in each of the reals' mean (one loader batch),
    # the sample reals and the fakes
    check(all(c[3] == 6 for c in vis), "expected 6 K1 launches a vis call")
    check(launches["mipmap_sample"] == 2 * TRAIN_ITERS + vis_k1
          and launches["mipmap_sample_dcoords"] == 2 * TRAIN_ITERS,
          "expected 2 K1 and 2 K3 launches per train step")
    check(launches["mipmap_sample_dpyramid"] == 0,
          "K5a launched for a pyramid that needs no gradient")
    run_dir = os.path.join(d, "results", "smoke")
    check_grids(run_dir, CATS_GRIDS, [c[0] for c in vis])
    mp4 = os.path.join(d, "transformed_sample.mp4")
    check(animate_visuals(run_dir, "transformed_sample", mp4) == len(vis)
          and os.path.getsize(mp4) > 0, "animate_visuals wrote no video")
    counts, n_kernels, size = trace_kernels(trace_dir)
    print(f"profiler window ({PROFILE_WINDOW[0]}, {PROFILE_WINDOW[1]}]: a "
          f"Chrome trace of {size / 2 ** 20:.1f} MiB, {n_kernels} kernel "
          f"events, K1 {counts['mipmap_pyramid_fwd']}, K3 "
          f"{counts['mipmap_pyramid_dcoords']}; {len(vis)} PNG grid sets "
          f"and {mp4.rsplit('/', 1)[-1]} of {len(vis)} frames written")
    check(counts["mipmap_pyramid_fwd"] > 0
          and counts["mipmap_pyramid_dcoords"] > 0,
          "the profiler's trace holds no K1 or no K3 kernel")
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
    check_resume(state, os.path.join(run_dir, "checkpoints", ckpts[-1]), dev)
    shutil.rmtree(d)
    return state, generator, perceptual, pfn, launches


def check_resume(state, path, dev):
    """The checkpoint at ``path`` resumed into a fresh state equals
    ``state``: parameters, EMA and Adam moments."""
    cfg = state.cfg
    fresh = TrainState(cfg, ComposedSTN(cfg.t, device=dev),
                       LatentLearner(cfg.ll, device=dev))
    train_ckpt.resume(fresh, train_ckpt.load_checkpoint(path))
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
    print(f"checkpoint {os.path.basename(path)} resumed: parameters, EMA and "
          "Adam moments equal")


class GridRecorder:
    """A writer that keeps the arrays handed to it, by grid name."""

    def __init__(self):
        self.grids = {}

    def log_image_grid(self, images, name, *a, **kw):
        self.grids[name] = images.detach().cpu() if torch.is_tensor(images) \
            else torch.from_numpy(np.asarray(images))


@contextlib.contextmanager
def vis_split(generator, t, writer):
    """Split the host-clock seconds of the visuals made in the block into
    the loader's PNG decodes, G's forwards, the STN's, the flows'
    colouring and the grids' assembly with their PNG encodes. The card is
    synchronised where each part starts and ends; a part nested in
    another counts as the outer one. Yields the seconds by part."""
    parts = {}
    depth, start = [0], [0.0]

    def enter(*_):
        if depth[0] == 0:
            torch.cuda.synchronize()
            start[0] = time.perf_counter()
        depth[0] += 1

    def leave(part):
        depth[0] -= 1
        if depth[0] == 0:
            torch.cuda.synchronize()
            parts[part] = parts.get(part, 0.0) + time.perf_counter() - start[0]

    def timed(fn, part):
        def run(*a, **kw):
            enter()
            try:
                return fn(*a, **kw)
            finally:
                leave(part)
        return run

    hooks = [h for part, model in (("G", generator), ("STN", t))
             for m in model.modules()
             for h in (m.register_forward_pre_hook(enter),
                       m.register_forward_hook(
                           lambda *_, p=part: leave(p)))]
    getitem, colour = MultiResolutionDataset.__getitem__, visuals_mod.flow_to_rgb
    MultiResolutionDataset.__getitem__ = timed(getitem, "PNG decode")
    visuals_mod.flow_to_rgb = timed(colour, "flow colouring")
    writer._grid = timed(writer._grid, "grids and PNG encode")
    try:
        yield parts
    finally:
        for h in hooks:
            h.remove()
        MultiResolutionDataset.__getitem__ = getitem
        visuals_mod.flow_to_rgb = colour
        del writer._grid


def cats_visuals(dev, card, state, generator, reals, errs):
    """create_training_visuals from the state cli.train wrote, at the cats
    recipe's n_sample and vis_batch_size, n_mean cut to VIS_REALS: seconds
    and peak memory of a call; a call split by part (vis_split), with each
    K1 launch held against its plain version; a call at batch 2 on the
    card against the port's CPU path (the same z and generator noise).
    Returns (seconds, peak GiB)."""
    cfg = state.cfg
    dset = MultiResolutionDataset(reals, resolution=256)
    loader = DataLoader(dset, batch_size=VIS_BATCH, shuffle=False,
                        drop_last=False)
    sample_reals = np.stack([dset[i] for i in range(VIS_SAMPLES)])
    rng = torch.Generator(dev).manual_seed(8)
    z = torch.randn(VIS_SAMPLES, cfg.g.style_dim, generator=rng, device=dev)
    d = tempfile.mkdtemp()
    writer = GANgealingWriter(d)

    def call():
        create_training_visuals(generator, state.t_ema, state.ll, loader,
                                sample_reals, z, 1.0, VIS_REALS, VIS_SAMPLES,
                                0, writer, rng=rng,
                                padding_mode=cfg.padding_mode)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    call()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    with recorded(mipmap_ops, "mipmap_sample") as k1, \
            vis_split(generator, state.t_ema, writer) as parts:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        split_s = time.perf_counter() - t0
    check(len(k1) == 6, f"a vis call launched K1 {len(k1)} times, expected 6")
    vis_errs = {}
    with torch.no_grad():
        hold("mipmap_sample", [(out, _sample_pyramid(*a)) for a, out in k1],
             vis_errs)
    writer.close()
    shutil.rmtree(d)
    print(f"cats vis call (n_sample {VIS_SAMPLES}, vis_batch_size "
          f"{VIS_BATCH}, n_mean {VIS_REALS}): {seconds:.2f} s, peak memory "
          f"{peak:.2f} GiB; its {len(k1)} K1 launches, inputs "
          f"{sorted({tuple(a[1].shape) for a, _ in k1})}: max abs err vs "
          f"plain {vis_errs['mipmap_sample']:.3e} [{card}]")
    print(f"a cats vis call split, the card synchronised at each part's "
          f"ends: {split_s:.3f} s, "
          f"{', '.join(f'{k} {v:.3f} s' for k, v in parts.items())}, the "
          f"rest {split_s - sum(parts.values()):.3f} s [{card}]")
    errs["mipmap_sample"] = max(errs.get("mipmap_sample", 0.0),
                                vis_errs["mipmap_sample"])

    # batch 2, the card (with cuDNN, as cli.train runs) against the CPU
    g = torch.Generator().manual_seed(9)
    z2 = torch.randn(2, cfg.g.style_dim, generator=g)
    noise = [[torch.randn(s, generator=g) for s in cfg.g.noise_shapes(2)]
             for _ in range(2)]
    cpu = [copy.deepcopy(m).cpu() for m in (generator, state.t_ema,
                                             state.ll)]
    runs = {}
    for d_, mods in ((dev, (generator, state.t_ema, state.ll)),
                     (torch.device("cpu"), cpu)):
        rec = GridRecorder()
        create_training_visuals(
            *mods, [sample_reals[:2]], sample_reals[:2], z2.to(d_), 1.0,
            2, 2, 0, rec, noise=[[n.to(d_) for n in ns] for ns in noise],
            padding_mode=cfg.padding_mode)
        runs[d_.type] = rec.grids
    check(set(runs["cuda"]) == set(runs["cpu"]) == {
        "mean_EMA_transformed_real_sample", "EMA_transformed_real_sample",
        "flow_real", "sample", "transformed_sample", "truncated_sample"},
        f"the batch-2 visuals logged {sorted(runs['cuda'])}")
    diffs = {k: float((v - runs["cpu"][k]).abs().max())
             for k, v in runs["cuda"].items()}
    print(f"card vs CPU path, a vis call at batch 2, the grids' arrays max "
          f"abs err: {', '.join(f'{k} {v:.3e}' for k, v in diffs.items())}")
    for k, v in diffs.items():
        check(v <= (FLOW_RGB_TOL if k == "flow_real" else OUT_TOL),
              f"the vis call's {k} differs from the CPU path: {v:.3e}")
    return seconds, peak


def train(dev, card, reals):
    state, generator, perceptual, pfn, cli_launches = cli_run(dev, reals)
    cfg = state.cfg
    # The card is held against the CPU path, and the trained state's K1
    # and K3 launches against their plain versions, at the state cli.train
    # wrote. The steps below go on training the random weights, which can
    # drift where a float32 step is ill-conditioned on any device (as the
    # cars run's do, cars_train).
    t_cli, ll_cli = copy.deepcopy(state.t), copy.deepcopy(state.ll)
    errs = {}
    vis_s, vis_peak = cats_visuals(dev, card, state, generator, reals, errs)
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

    # each K1 and K3 launch of a step from the trained state (the one
    # cli.train wrote), and of one from the identity init, where every
    # point sits on an integer coordinate, the first row and column on the
    # border clamp and every level on 1
    st_cli = TrainState(cfg, copy.deepcopy(t_cli), copy.deepcopy(ll_cli))
    st_id = TrainState(cfg, copy.deepcopy(t_id), copy.deepcopy(state.ll))
    for what, st in (("trained state", st_cli), ("identity init", st_id)):
        with recorded(mipmap_ops, "mipmap_sample") as k1, \
                recorded(mipmap_ops, "mipmap_sample_dcoords") as k3:
            step(st)
        check(len(k1) == 2 and len(k3) == 2, f"a step from the {what} did "
              "not launch K1 and K3 twice")
        if what == "trained state":
            k3_trained = k3
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
    # K3's device time and each head's warp are timed on a step from the
    # state the timed steps reached, as before the gates moved to the state
    # cli.train wrote
    with recorded(mipmap_ops, "mipmap_sample_dcoords") as k3_timed, \
            recorded(stn_ops, "mipmap_warp") as warps_timed:
        step()
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
            k3_timed, k3_graph, mipmap_ops.mipmap_sample_dcoords),
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
    for head, (args, _) in zip(("similarity", "flow"), warps_timed):
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

    step()
    torch.cuda.synchronize()
    prof = profiled(lambda: [step() for _ in range(2)])
    print_groups(f"step at batch {TRAIN_BATCH}, 2 steps", 2,
                 *kernel_groups(prof, STEP_GROUPS), card, top=8)

    for what, t, ll in (("trained state", t_cli, ll_cli),
                        ("identity init", t_id, state.ll)):
        f32_card, _ = card_vs_cpu_step(cfg, t, ll, generator, perceptual,
                                       dev, what)
        bf16_card_vs_cpu_step(cfg, t, ll, generator, perceptual, dev, what,
                              f32_card)
    cycle = VIS_CYCLE * TRAIN_BATCH / rate
    print(f"cats vis call: {vis_s:.2f} s, peak {vis_peak:.2f} GiB; a "
          f"{VIS_CYCLE}-iteration cycle at {rate:.1f} imgs/s takes "
          f"{cycle:.0f} s, the vis call {vis_s / cycle:.4%} of it [{card}]")
    # the side checks' launches, apart from the main path's (cli.train)
    check_launches = {k: no_aa_launches[k] + image_launches[k]
                      for k in LAUNCHES}
    return (rate, peak, cli_launches, check_launches, errs, times,
            (vis_s, vis_peak))


def step_batch2(cfg):
    """z and the generator's noise of a batch-2 step, from a seed."""
    g = torch.Generator().manual_seed(7)
    z = torch.randn(2, cfg.g.style_dim, generator=g)
    shapes = cfg.g.noise_shapes(2)
    return z, [[torch.randn(s, generator=g) for s in shapes] for _ in range(2)]


def step_grads(cfg, t, ll, generator, perceptual, d, z, noise):
    """One step's loss terms and the gradients of every STN and ``ll``
    parameter on device ``d``, from copies of the modules."""
    loss = make_perceptual_loss(cfg.loss_fn, dtype_of(cfg.compute_dtype))
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
    the port's CPU path, from the same STN ``t``, ``ll``, z and noise.
    Returns the card's run and the CPU path's."""
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
          f"{what}: the gradients differ from the CPU path (worst tensor "
          f"{worst[1]} at {worst[0]:.3e}, all {l2:.3e} in L2)")
    return runs


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


# The eval phase: PCK-Transfer at the shape of the JAX package's
# bench.py::bench_pck (the similarity STN iterated 3 times, the 4-way flip
# match, both ways, three alphas) at the eval CLI's batch of 50 over 200
# pairs of 400 smooth 256 px images (SPair-shaped sidecars: 15 key points
# with visibility, per-image thresholds, a left-right permutation); flow
# scores over the 400 images; congeal_dataset over 64 of them.
EVAL_IMAGES = 400
EVAL_BATCH = 50
EVAL_KPS = 15
PCK_ITERS = 3
PCK_ALPHAS = (0.1, 0.05, 0.01)
CONGEAL_IMAGES = 64
# Card against the port's CPU path: transferred points within 0.05 px
# (AR_PT_TOL), flow scores within 1e-4 relative, aligned images within
# OUT_TOL; an inversion pick may differ only where the CPU path's own
# distances at the two texels differ by under 1e-5 relative.
SCORE_RTOL, TIE_REL = 1e-4, 1e-5


def png_bytes(img):
    """A (3, H, W) image in [-1, 1] as PNG bytes."""
    import io
    from PIL import Image
    arr = np.round((img + 1) * 127.5).clip(0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr.transpose(1, 2, 0)).save(buf, format="PNG")
    return buf.getvalue()


def image_lmdb(path, imgs):
    """The images as an LMDB of PNGs, as the port's prepare_data writes
    one, through the port's own writer; encoded on 8 threads."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(8) as pool:
        encoded = list(pool.map(png_bytes, imgs))
    items = {f"256-{str(i).zfill(5)}".encode(): b
             for i, b in enumerate(encoded)}
    items[b"length"] = str(len(imgs)).encode()
    write_lmdb(path, items)
    return path


def spair_sidecars(path, n, rng):
    """SPair-shaped sidecars for n images in n / 2 fixed pairs (2i, 2i+1):
    15 key points with visibility, a bounding-box threshold and an inverse
    transform an image, the cat category's left-right permutation. The
    even pairs are one image twice with the same key points."""
    kps = np.concatenate([rng.rand(n, EVAL_KPS, 2) * 255,
                          rng.rand(n, EVAL_KPS, 1) > 0.2], 2)
    kps[1::4] = kps[0::4]
    torch.save(torch.from_numpy(kps.astype(np.float32)),
               os.path.join(path, "keypoints.pt"))
    torch.save(torch.arange(n).view(n // 2, 2), os.path.join(path, "pairs.pt"))
    torch.save(torch.from_numpy(rng.uniform(100, 250, n).astype(np.float32)),
               os.path.join(path, "pck_thresholds.pt"))
    inverse = np.stack([rng.randint(0, 30, n), rng.randint(0, 30, n),
                        rng.uniform(0.8, 1.2, n)], 1).astype(np.float32)
    torch.save(torch.from_numpy(inverse),
               os.path.join(path, "inverse_coordinates.pt"))
    torch.save(SPAIR_PERMUTATIONS["cat"], os.path.join(path, "permutation.pt"))


def eval_images(n, seed):
    """n smooth 256 px images whose pairs (4i, 4i+1) are one image twice."""
    imgs = smooth_images(n, torch.Generator().manual_seed(seed)).numpy()
    imgs[1::4] = imgs[0::4]
    return imgs


def run_pck(model, dset, num_pairs):
    return pck_app.pck_transfer(
        model, DataLoader(dset, batch_size=EVAL_BATCH, shuffle=False,
                          drop_last=False),
        alphas=PCK_ALPHAS, num_pairs=num_pairs, iters=PCK_ITERS,
        transfer_both_ways=True, permutation=dset.mirror_permutation)


def check_pck(pck):
    check(pck.shape == (len(PCK_ALPHAS),) and bool(np.isfinite(pck).all())
          and bool(((pck >= 0) & (pck <= 1)).all())
          and pck[0] >= pck[1] >= pck[2], f"PCK values {pck}")


def eval_groups():
    return (("K1 mipmap_sample", ("mipmap_pyramid_fwd",)),
            ("K2 grid_sample", ("grid_sample_kernel",)),
            ("nearest-texel argmin", ("argmin",)),
            ("depthwise FIR convs", ("conv_depthwise2d",)),
            CONV_GROUP,
            ("host-device copies", ("memcpy",)),
            ("pads", ("pad",)),
            ("gather and index", ("gather", "index")))


def nn_inputs(model, imgs, points, iters):
    """The grid and the normalized points the flow stage of
    composed_congeal_points inverts, and its picks."""
    with torch.inference_mode():
        out0, warp, cong0 = stn_ops.stn_congeal_points(
            model.stns[0], imgs, points, unnormalize_output_points=True,
            output_resolution=model.cfg.flow_size, iters=iters,
            input_img_for_sampling=imgs, return_full=True)
        _, fom, picks = stn_ops.stn_congeal_points(
            model.stns[1], out0, cong0, base_warp=warp,
            input_img_for_sampling=imgs, return_full=True)
        ident = stn_ops.identity_grid(1, fom.shape[1], fom.shape[2],
                                      dtype=fom.dtype, device=fom.device)
        pts = normalize_points(cong0, imgs.shape[-1], imgs.shape[-1])
    return fom + ident, pts, picks


def near_tie_picks(grid, points, ours, ref):
    """Where the card's inversion picked another texel than the CPU
    path's: check that the CPU path's own distances at the two texels
    differ by under TIE_REL relative; returns the mask of those points."""
    differ = (ours != ref).any(-1)
    N, H, W, _ = grid.shape
    g = grid.reshape(N, H * W, 2)
    for n, p in zip(*torch.nonzero(differ, as_tuple=True)):
        pt = points[n, p]

        def dist(xy):
            gv = g[n, int(xy[1]) * W + int(xy[0])]
            return float((pt @ pt + gv @ gv) - 2 * (gv @ pt))
        d_ours, d_ref = dist(ours[n, p]), dist(ref[n, p])
        check(abs(d_ours - d_ref) <= TIE_REL * max(abs(d_ours), abs(d_ref),
                                                   1e-30),
              f"the card's inversion picked {ours[n, p].tolist()} against "
              f"{ref[n, p].tolist()}, distances {d_ours} and {d_ref}")
    return differ


def eval_card_vs_cpu(model, cpu_model, dset, imgs, out, card_name):
    """2 pairs, 4 images: the 4-way match, the transferred points, the PCK
    counts, the flow scores and congeal_dataset's decisions, on the card
    and on the port's CPU path."""
    batch = next(iter(DataLoader(dset, batch_size=2)))
    perm = dset.mirror_permutation
    kw = dict(iters=PCK_ITERS, padding_mode="border")
    res = {}
    for name, m in (("card", model), ("cpu", cpu_model)):
        dev = next(m.parameters()).device
        A, B, kA, kB, vis, tA, tB = pck_app.batch_tensors(batch, dev)
        with torch.inference_mode():
            A, B, kA, kB, pick = stn_ops.composed_match_flows(
                m, A, B, kA, kB, permutation=perm, **kw)
            moved = [stn_ops.composed_transfer_points(m, src, dst, k, **kw)
                     for src, dst, k in ((A, B, kA), (B, A, kB))]
            counts = pck_app.pck_batch(m, *pck_app.batch_tensors(batch, dev),
                                       PCK_ALPHAS, transfer_both_ways=True,
                                       permutation=perm, **kw)
        ties = [nn_inputs(m, src, k, PCK_ITERS) for src, k in ((A, kA),
                                                               (B, kB))]
        res[name] = dict(pick=pick.cpu(), moved=[t.cpu() for t in moved],
                         counts=[t.cpu() for t in counts],
                         ties=[[t.cpu() for t in x] for x in ties])
    card, cpu = res["card"], res["cpu"]
    check(torch.equal(card["pick"], cpu["pick"]),
          f"match_flows picks {card['pick'].ravel().tolist()} on the card, "
          f"{cpu['pick'].ravel().tolist()} on the CPU path")
    n_ties, pt_err = 0, 0.0
    for way in range(2):
        grid, pts, ref_picks = cpu["ties"][way]
        tie = near_tie_picks(grid, pts, card["ties"][way][2], ref_picks)
        n_ties += int(tie.sum())
        keep = ~tie
        pt_err = max(pt_err, float((card["moved"][way][keep]
                                    - cpu["moved"][way][keep]).abs().max()))
    check(pt_err <= AR_PT_TOL, f"PCK: transferred points {pt_err:.3e} px "
          "from the CPU path")
    check(torch.equal(card["counts"][0], cpu["counts"][0])
          and float(card["counts"][1]) == float(cpu["counts"][1]),
          f"PCK counts {card['counts']} on the card, {cpu['counts']} on the "
          "CPU path")
    small = image_lmdb(os.path.join(out, "four"), imgs[:4])
    scores = {name: flow_app.compute_flow_scores(
        m, small, batch=4, save=False, device=next(m.parameters()).device)
        for name, m in (("card", model), ("cpu", cpu_model))}
    rel = float(np.abs(scores["card"] - scores["cpu"]).max()
                / np.abs(scores["cpu"]).max())
    check(rel <= SCORE_RTOL, f"flow scores {rel:.3e} relative from the CPU "
          "path")
    decided, aligned = {}, {}
    x = torch.from_numpy(imgs[:4])
    x_in, bounds = interpolate_bilinear(x, 128, 128), torch.full((4, 2), 256.0)
    cpu64 = copy.deepcopy(cpu_model).double()
    for name, m, cudnn, dtype in (
            ("card", model, True, torch.float32),
            ("card, no cuDNN", model, False, torch.float32),
            ("cpu", cpu_model, True, torch.float32),
            ("cpu float64", cpu64, True, torch.float64)):
        dev = next(m.parameters()).device
        torch.backends.cudnn.enabled = cudnn
        with torch.inference_mode():
            a, scale, oob = congeal_app.congeal_batch(
                m, *(t.to(dev, dtype) for t in (x_in, x, bounds)), 256)
            M = m.stns[0](x_in.to(dev, dtype), input_img_for_sampling=x.to(
                dev, dtype), output_resolution=256)[2].cpu().double()
        torch.backends.cudnn.enabled = True
        aligned[name] = (a.cpu().double(), M)
        decided[name] = ((scale.cpu() * 256 >= 192) & ~oob.cpu()).tolist()
    del cpu64
    for name, m in (("card", model), ("cpu", cpu_model)):
        decided[name + " app"] = congeal_app.align_and_filter_dataset(
            m, small, os.path.join(out, f"aligned_{name}"), batch=4,
            device=next(m.parameters()).device)
    check(all(decided[k] == decided["cpu"] for k in aligned)
          and decided["card app"] == decided["cpu app"],
          f"congeal_dataset decisions differ: {decided}")
    # The aligned images and the similarity matrix of each path against
    # the CPU path and against float64; then the warp alone on one grid.
    # cuDNN's own algorithms carry several times float32's rounding into
    # the regressed matrix, which the 256 px output turns into about 5e-4
    # (PERF.md): the gate holds the card's path with its native
    # convolutions, and cuDNN's reading is printed beside it.
    far = {k: [float((aligned[k][i] - aligned["cpu"][i]).abs().max())
               for i in range(2)] for k in aligned}
    to64 = {k: float((aligned[k][0] - aligned["cpu float64"][0]).abs().max())
            for k in aligned}
    grid = affine_grid(aligned["cpu"][1].float(), (4, 3, 256, 256))
    card_dev = next(model.parameters()).device
    with torch.inference_mode():
        warp = float((stn_ops._warp(x.to(card_dev), grid.to(card_dev), True,
                                    "border").cpu()
                      - stn_ops._warp(x, grid, True, "border")).abs().max())
    check(far["card, no cuDNN"][0] <= OUT_TOL,
          f"aligned images {far['card, no cuDNN'][0]:.3e} from the CPU path")
    check(warp <= KERNEL_TOL, f"the warp on one grid {warp:.3e} from the CPU "
          "path")
    print(f"card vs CPU path, eval on 2 pairs and 4 images: match_flows "
          f"picks {card['pick'].ravel().tolist()} equal; transferred points "
          f"{pt_err:.3e} px ({n_ties} near-tie inversion picks of "
          f"{2 * card['moved'][0].shape[0] * card['moved'][0].shape[1]}); "
          f"PCK counts {card['counts'][0].tolist()} of "
          f"{float(card['counts'][1])} equal; flow scores {rel:.3e} "
          f"relative; congeal_dataset decisions {decided['card']} and "
          f"accepted {decided['card app']} equal [{card_name}]")
    print("card vs CPU path, congeal_batch's aligned images (similarity "
          "matrices) of 4 images at 256 px: "
          + "; ".join(f"{k} {far[k][0]:.3e} ({far[k][1]:.3e}) from the CPU "
                      f"path, {to64[k]:.3e} from float64"
                      for k in ("card", "card, no cuDNN", "cpu"))
          + f"; the warp alone on the CPU path's grid {warp:.3e} "
          f"[{card_name}]")


def eval_clis(path, d, imgs, label_png):
    """Each eval CLI's main() once on the card, on small inputs, and the
    files it writes."""
    from PIL import Image
    small = image_lmdb(os.path.join(d, "cli_pck"), imgs[:8])
    spair_sidecars(small, 8, np.random.RandomState(9))
    vis = os.path.join(d, "pck_vis")
    pck, _ = pck_cli.main(["--ckpt", path, "--real_data_path", small,
                           "--batch", "4", "--vis_transfer", "--out", vis,
                           "--device", "cuda"])
    check_pck(pck)
    for name in ("transfer_grid.png", "congealed.png"):
        check(os.path.getsize(os.path.join(vis, "transfers", name)) > 0,
              f"cli.pck wrote no {name}")
    distinct = np.delete(imgs, np.s_[1::4], 0)[:16]  # no image twice
    data = image_lmdb(os.path.join(d, "cli_data"), distinct)
    scores = flow_scores_cli.main(["--ckpt", path, "--real_data_path", data,
                                   "--device", "cuda"])
    cache = os.path.join(data, "flow_scores.pt")
    check(scores.shape == (len(distinct),) and os.path.getsize(cache) > 0,
          "cli.flow_scores wrote no scores")
    out = os.path.join(d, "cli_aligned")
    used = congeal_dataset_cli.main(["--ckpt", path, "--real_data_path",
                                     data, "--out", out, "--device", "cuda"])
    check(LMDBReader(out).get(b"length") == str(len(used)).encode(),
          "cli.congeal_dataset wrote no LMDB of its accepted images")
    folder = os.path.join(d, "pngs")
    os.makedirs(folder)
    for i, img in enumerate(imgs[:8]):
        Image.fromarray(np.round((img + 1) * 127.5).astype(np.uint8)
                        .transpose(1, 2, 0)).save(
            os.path.join(folder, f"{i:05d}.png"))
    built = os.path.join(d, "built")
    n = prepare_data_cli.main(["--out", built, "--path", folder, "--size",
                               "256,128", "--format", "png"])
    check(n == 8 and MultiResolutionDataset(built, 128)[7].shape
          == (3, 128, 128), "cli.prepare_data built no dataset")
    vis = os.path.join(d, "prop_vis")
    with recorded(splat_ops, "splat2d_pair_cuda") as k6:
        result = propagate_cli.main([
            "--ckpt", path, "--real_data_path", data, "--label_path",
            label_png, "--objects", "--flow_scores", cache,
            "--fraction_retained", "0.5", "--n_images", "8", "--resolution",
            "128", "--out", vis, "--device", "cuda"])
    check_ar(result, min(8, len(flow_app.get_high_score_indices(scores,
                                                                0.5))))
    for name in ("congealed.png", "propagated.png"):
        check(os.path.getsize(os.path.join(vis, name)) > 0,
              f"cli.propagate_to_images wrote no {name}")
    print(f"eval CLIs on the card: cli.pck PCK {pck.tolist()} and its "
          f"transfer visuals, cli.flow_scores {scores.shape[0]} scores, "
          f"cli.congeal_dataset {len(used)} of {len(distinct)} accepted, "
          f"cli.prepare_data {n} images at 256 and 128 px, "
          f"cli.propagate_to_images {result['propagated'].shape[0]} images "
          f"of the flow-filtered set")
    return k6


def evaluate(dev, card):
    """The eval path on the card (the eval phase)."""
    start = time.perf_counter()
    d = tempfile.mkdtemp()
    path = os.path.join(d, "stn.pt")
    make_checkpoint(path)
    model, cfg = load_stn(path, supersize=256, device=dev)
    cpu_model, _ = load_stn(path, supersize=256, device="cpu")
    check(cfg == FLAGSHIP, f"load_stn built {cfg}")
    t0 = time.perf_counter()
    imgs = eval_images(EVAL_IMAGES, 10)
    data = image_lmdb(os.path.join(d, "pck"), imgs)
    spair_sidecars(data, EVAL_IMAGES, np.random.RandomState(11))
    cdata = image_lmdb(os.path.join(d, "congeal"), imgs[:CONGEAL_IMAGES])
    dset = PCKDataset(data, resolution=256)
    reader = "native" if dset.reader._h is not None else "pure Python"
    print(f"eval data: {EVAL_IMAGES} smooth 256 px PNGs in an LMDB, "
          f"{len(dset)} fixed pairs, {EVAL_KPS} key points an image, written "
          f"in {time.perf_counter() - t0:.2f} s; LMDB reader: {reader} "
          f"({'build/torch_native/liblmdb_kv.so' if dset.reader._h else ''})")
    check(dset.reader._h is not None, "the native LMDB reader did not load")
    label, rgba = synthetic_label()
    label_png = write_label(rgba, d)
    pairs = len(dset)

    # the main path: every launch count starts at 0 here
    zero_launches()
    check_pck(run_pck(model, dset, EVAL_BATCH))  # warm-up: the first batch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    pck = run_pck(model, dset, None)
    pck_s = time.perf_counter() - t0
    pck_peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    check_pck(pck)
    prof = profiled(lambda: run_pck(model, dset, 2 * EVAL_BATCH))
    pck_groups = kernel_groups(prof, eval_groups())
    with recorded(mipmap_ops, "mipmap_sample") as k1, \
            recorded(grid_sample_ops, "grid_sample_cuda") as k2:
        check_pck(run_pck(model, dset, EVAL_BATCH))
    check(len(k1) == 20 and len(k2) == 2, f"a PCK batch launched K1 "
          f"{len(k1)} and K2 {len(k2)} times; expected 20 and 2")
    errs = ar_kernels_vs_plain(k1, k2, [])
    del k1, k2

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    scores = flow_app.compute_flow_scores(model, data, batch=EVAL_BATCH,
                                          device=dev)
    score_s = time.perf_counter() - t0
    score_peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    check(scores.shape == (EVAL_IMAGES,) and bool(np.isfinite(scores).all()),
          "flow scores")
    prof = profiled(lambda: flow_app.compute_flow_scores(
        model, cdata, batch=EVAL_BATCH, save=False, device=dev))
    score_groups = kernel_groups(prof, eval_groups())
    kept = flow_app.filter_dataset(MultiResolutionDataset(data, 256),
                                   os.path.join(data, "flow_scores.pt"), 0.5)
    # a duplicated image scores as its twin: ties at the median drop out
    check(0 < len(kept) <= EVAL_IMAGES // 2,
          f"filter_dataset kept {len(kept)}")

    t0 = time.perf_counter()
    used = congeal_app.align_and_filter_dataset(
        model, cdata, os.path.join(d, "aligned"), device=dev)
    congeal_s = time.perf_counter() - t0
    check(LMDBReader(os.path.join(d, "aligned")).get(b"length")
          == str(len(used)).encode(), "congeal_dataset wrote no LMDB")
    t0 = time.perf_counter()
    k6 = eval_clis(path, d, imgs, label_png)
    clis_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    hold_pairs(k6, errs, max_sigma=1.3)
    print(f"eval main path: {pairs // EVAL_BATCH + 4} PCK batches, flow "
          f"scores over {EVAL_IMAGES + CONGEAL_IMAGES} images, "
          f"congeal_dataset over {CONGEAL_IMAGES}, the five CLIs; launches "
          f"{launches}")
    check(launches["mipmap_sample"] > 0 and launches["grid_sample"] > 0
          and launches["splat"] > 0
          and all(launches[k] == 0 for k in LAUNCHES if k not in (
              "mipmap_sample", "grid_sample", "splat")),
          f"the eval path launched {launches}")
    print(f"eval kernel launches held against the plain versions: max abs "
          f"err K1 {errs['mipmap_sample']:.3e} (20 launches of a PCK "
          f"batch), K2 {errs['grid_sample']:.3e} (2), K6 "
          f"{errs['splat']:.3e} (cli.propagate_to_images) [{card}]")
    print(f"PCK-Transfer: {pairs / pck_s:.2f} pairs/s over {pairs} pairs in "
          f"{pck_s:.2f} s (batch {EVAL_BATCH}, iters {PCK_ITERS}, 4-way "
          f"match, both ways, decode included), PCK "
          f"{', '.join(f'@{a} {p:.4f}' for a, p in zip(PCK_ALPHAS, pck))}, "
          f"peak memory {pck_peak:.2f} GiB [{card}]")
    print_groups(f"batch of {EVAL_BATCH} pairs in PCK-Transfer, 2 batches",
                 2, *pck_groups, card, top=4)
    print(f"flow scores: {EVAL_IMAGES / score_s:.1f} imgs/s over "
          f"{EVAL_IMAGES} images in {score_s:.2f} s (batch {EVAL_BATCH}, "
          f"decode included), peak memory {score_peak:.2f} GiB; "
          f"filter_dataset at 0.5 kept {len(kept)} [{card}]")
    print_groups(f"{EVAL_BATCH} images in flow scores, {CONGEAL_IMAGES} "
                 f"images in {-(-CONGEAL_IMAGES // EVAL_BATCH)} batches",
                 CONGEAL_IMAGES / EVAL_BATCH, *score_groups, card)
    print(f"congeal_dataset: {CONGEAL_IMAGES / congeal_s:.1f} imgs/s over "
          f"{CONGEAL_IMAGES} images in {congeal_s:.2f} s (the CLI's defaults:"
          f" batch 50, output 256 px, min effective resolution 192), "
          f"{len(used)} accepted, their PNGs and LMDB written [{card}]")
    t0 = time.perf_counter()
    eval_card_vs_cpu(model, cpu_model, dset, imgs, d, card)
    shutil.rmtree(d)
    print(f"eval phase: {time.perf_counter() - start:.1f} s; the CLIs "
          f"{clis_s:.1f} s, the card against the CPU path "
          f"{time.perf_counter() - t0:.1f} s of it [{card}]")
    return launches, errs


# The cluster phase: the reference's LSUN-cars run
# (scripts/training/lsun_cars.sh: 4 heads and flips, 5 directions, inject
# 6, G's 256 px image sampled, reflection padding, tv_weight 2500, lpips;
# the argparse defaults for the rest, the cats run's widths) at CARS_BATCH
# on one card, seeded random G, STN and LPIPS, --debug (the cold start's
# PCA on 1000 latents and its centroids the first 4 of them); then its
# classifier (scripts/training/lsun_cars_cluster_classifier.sh: 2K = 8
# logits, warm-started from the trained STN's EMA) and the AR apps with
# it. CARS_BATCH: the largest multiple of 5 up to the recipe's global 40
# whose step peaks under 90% of the card's 80 GB (PERF.md section 4).
# CLS_BATCH: the classifier recipe's global 40 (8 GPUs x 5), which one card
# holds, as its step runs no backward through G, the STN or LPIPS.
CARS_BATCH = 20
CARS_HEADS = 4
CARS_ITERS = 2
CARS_TIMED = 8
CLS_BATCH = 40
CLS_ITERS = 2
CLS_TIMED = 4
# K-Means++ timed once at this many latents (the recipe takes 50,000)
KMEANS_LATENTS = 1000
# two distances, or two logits, closer than this (relative) are a near
# tie, where the card and the CPU may decide apart
NEAR_TIE = 1e-5


def cars_argv(results, ckpt, batch, iters, *extra):
    """The LSUN-cars flags (lsun_cars.sh) for ``iters`` iterations at
    ``batch`` on one card, a checkpoint at the last."""
    return ["--exp-name", "cars", "--results", results, "--ckpt", ckpt,
            "--padding_mode", "reflection", "--tv_weight", "2500",
            "--loss_fn", "lpips", "--num_heads", str(CARS_HEADS), "--flips",
            "--ndirs", "5", "--inject", "6", "--sample_from_full_res",
            "--batch", str(batch), "--iter", str(iters), "--ckpt_every",
            str(iters), "--vis_every", "0", "--log_every", "1", "--debug",
            *extra]


def cluster_step_batch2(cfg, seed):
    """z and both generator passes' noise of a batch-2 clustered step (the
    second pass at 2K images)."""
    g = torch.Generator().manual_seed(seed)
    z = torch.randn(2, cfg.g.style_dim, generator=g)
    return z, [[torch.randn(s, generator=g) for s in cfg.g.noise_shapes(b)]
               for b in (2, 2 * cfg.t.num_heads)]


def cluster_step_grads(cfg, t, ll, generator, perceptual, d, z, noise):
    """One clustered step's loss terms, assignments and the gradients of
    every STN and ``ll`` parameter on device ``d``, from copies."""
    loss = make_perceptual_loss(cfg.loss_fn, dtype_of(cfg.compute_dtype))
    gen = copy.deepcopy(generator).to(d)
    lp = copy.deepcopy(perceptual).to(d)
    st = TrainState(cfg, copy.deepcopy(t).to(d), copy.deepcopy(ll).to(d))
    m = train_step(st, gen, lambda x, y: loss(lp, x, y), z.to(d), 0.5,
                   0.0, 0.0, noise=[[n.to(d) for n in ns] for ns in noise])
    grads = {k: p.grad.cpu() for k, p in st.t.named_parameters()}
    grads["ll.coefficients"] = st.ll.coefficients.grad.cpu()
    assigned = m.pop("assignments").cpu()
    return {k: float(v) for k, v in m.items()}, grads, assigned


def cpu_distances(cfg, t, ll, generator, perceptual, z, noise):
    """The CPU path's distances of a batch-2 step: which rows are near
    ties."""
    loss = make_perceptual_loss(cfg.loss_fn, dtype_of(cfg.compute_dtype))
    with torch.no_grad():
        return assign_fake_images_to_clusters(
            copy.deepcopy(generator).cpu(), copy.deepcopy(t).cpu(),
            copy.deepcopy(ll).cpu(),
            lambda x, y: loss(copy.deepcopy(perceptual).cpu(), x, y), z, 0.5,
            cfg.t.num_heads, cfg.flips, freeze_ll=cfg.freeze_ll,
            sample_from_full_res=cfg.sample_from_full_res,
            padding_mode=cfg.padding_mode, noise=noise,
            compute_dtype=dtype_of(cfg.compute_dtype))[6]


def near_ties(distances, gap=NEAR_TIE):
    """Rows whose two least distances are within ``gap`` relative."""
    d = distances.sort(dim=1).values
    return ((d[:, 1] - d[:, 0]) / d[:, 0].abs() <= gap).nonzero()[:, 0]


def cluster_card_vs_cpu_step(cfg, t, ll, generator, perceptual, dev):
    """One clustered step at batch 2 (K = 4, flips) on the card and on the
    port's CPU path: equal assignments, loss terms 1e-4 relative, the
    gradients within TRAIN_GRAD_TOL (each tensor) and TRAIN_GRAD_L2_TOL
    (all); in bfloat16 within BF16_CLUSTER_GATES through ``bf16_check``.
    An assignment that differs at a near tie of the CPU path's distances
    (NEAR_TIE, BF16_TIE) is counted and printed, and the step is taken
    again with the next z (up to 3); any other difference fails. Returns
    the count and the card's run with its z seed."""
    bf16 = cfg.compute_dtype == "bfloat16"
    gap = BF16_TIE if bf16 else NEAR_TIE
    ties = 0
    for seed in (7, 8, 9):
        z, noise = cluster_step_batch2(cfg, seed)
        runs = [cluster_step_grads(cfg, t, ll, generator, perceptual, d, z,
                                   noise) for d in (dev, torch.device("cpu"))]
        differ = (runs[0][2] != runs[1][2]).nonzero()[:, 0]
        if len(differ):
            near = set(near_ties(cpu_distances(
                cfg, t, ll, generator, perceptual, z, noise), gap).tolist())
            print(f"card vs CPU path, a {cfg.compute_dtype} clustered step "
                  f"at batch 2 (z seed {seed}): assignments "
                  f"{runs[0][2].tolist()} vs {runs[1][2].tolist()}, rows "
                  f"{differ.tolist()} differ, near ties (within {gap} "
                  f"relative) {sorted(near)}")
            check(set(differ.tolist()) <= near, "the clustered step's "
                  "assignments differ from the CPU path away from a tie")
            ties += len(differ)
            continue
        what = (f"a {cfg.compute_dtype} clustered step at batch 2, K "
                f"{cfg.t.num_heads}, flips (z seed {seed}), assignments "
                f"{runs[0][2].tolist()} equal, assignments that differed at "
                f"a near tie before this z: {ties}")
        if bf16:
            bf16_check(runs[0][:2], runs[1][:2], BF16_CLUSTER_GATES, what)
            return ties, (seed, runs[0])
        rel, worst, l2 = compare_steps(runs[0][:2], runs[1][:2])
        print(f"card vs CPU path, {what}; loss terms {runs[0][0]} vs "
              f"{runs[1][0]} (relative {rel:.3e}); worst gradient "
              f"{worst[1]} at {worst[0]:.3e} of its largest value; all "
              f"gradients {l2:.3e} in relative L2 norm")
        check(rel <= 1e-4, "the clustered step's loss terms differ from the "
              "CPU path")
        check(worst[0] <= TRAIN_GRAD_TOL and l2 <= TRAIN_GRAD_L2_TOL,
              "the clustered step's gradients differ from the CPU path")
        return ties, (seed, runs[0])
    raise AssertionError("three clustered steps each met a near tie")


def cars_kernels(state, step, card):
    """Each K1 and K3 launch of one cars step held against its plain
    version (reflection padding, 2NK streams over G's 256 px image); K1
    and K3 timed on those inputs beside their plain versions, bounds and
    F.grid_sample on the volume; the pyramid's build on the 2NK repeated
    sources against one for each of the 2N images. Returns the errors and
    K1's and K3's figures, per launch, averaged over the two heads."""
    with recorded(mipmap_ops, "mipmap_sample") as k1, \
            recorded(mipmap_ops, "mipmap_sample_dcoords") as k3, \
            recorded(stn_ops, "mipmap_warp") as warps:
        step()
    check(len(k1) == 2 and len(k3) == 2, "a cars step did not launch K1 "
          "and K3 twice")
    errs = {}
    with torch.no_grad():
        hold("mipmap_sample", [(out, _sample_pyramid(*a)) for a, out in k1],
             errs)
    hold("mipmap_sample_dcoords", backward_pairs(k3, k3_graph), errs)
    rows = []
    for head, (args, out), wargs in zip(("similarity", "flow"), k1, warps):
        pyramid, grid, levels, pm = args
        img = wargs[0][0].detach()
        with torch.inference_mode():
            ms = device_ms(lambda: mipmap_sample(*args))
            plain_ms = device_ms(lambda: _sample_pyramid(*args))
            volume = as_volume(_rebuild_stack(pyramid))
            grid3 = volume_grid(grid, levels, pyramid.shape.num_levels)
            lib_ms = device_ms(lambda: F.grid_sample(
                volume, grid3, mode="bilinear", padding_mode=pm,
                align_corners=False))
            del volume, grid3
            b = bound(pyramid_texel_bytes(img.shape, grid, levels, pm)
                      + nbytes(grid, levels, out),
                      sampler_ops("mipmap_sample", levels.numel(),
                                  out.shape[1]))
            streams = img.shape[0]
            build_ms = device_ms(lambda: _build_pyramid(
                img, pyramid.shape.num_levels))
            once_ms = device_ms(lambda: _build_pyramid(
                img[::CARS_HEADS], pyramid.shape.num_levels))
        w_ms, w_k_ms = warp_ms(img, grid.detach(), pm, backward=True)
        print(f"K1 in the {head} head of a cars step, inputs "
              f"{tuple(img.shape)} {tuple(grid.shape)} ({pm}), levels "
              f"{float(levels.detach().min()):.2f}-"
              f"{float(levels.detach().max()):.2f}, device "
              f"time: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"F.grid_sample on the volume {lib_ms:.4f} ms; bound on the "
              f"pyramid {b[0]:.4f} ms ({b[1]}); the warp and its backward "
              f"to the grid {w_ms:.4f} ms, its mipmap kernels {w_k_ms:.4f} "
              f"ms; the pyramid's build on the {streams} repeated sources "
              f"{build_ms:.4f} ms, on the {streams // CARS_HEADS} distinct "
              f"ones {once_ms:.4f} ms [{card}]")
        rows.append((ms, plain_ms, *b, lib_ms))
    k1_row = tuple((rows[0][i] + rows[1][i]) / 2 if i != 3 else rows[1][i]
                   for i in range(5))
    k3_row = backward_times(k3, k3_graph, mipmap_ops.mipmap_sample_dcoords)
    print(f"K3 at the cars step's shapes (the similarity head's launch), "
          f"device time: kernel {k3_row[0]:.4f} ms, plain autograd "
          f"{k3_row[1]:.4f} ms, backward of F.grid_sample on the volume "
          f"{k3_row[4]:.4f} ms; bound {k3_row[2]:.4f} ms ({k3_row[3]}) "
          f"[{card}]")
    print(f"K1 and K3 launches of a cars step held against the plain "
          f"versions: max abs err K1 {errs['mipmap_sample']:.3e}, K3 "
          f"{errs['mipmap_sample_dcoords']:.3e}")
    return errs, {"mipmap_sample": k1_row, "mipmap_sample_dcoords": k3_row}


def cars_train(dev, card, d, batch, reals):
    """cli.train on the cars flags with its cluster visuals at the start,
    the timed steps, the kernels at their shapes, where the time goes, and
    the card against the CPU path. Returns the state and what the
    classifier and the report need."""
    gpath = os.path.join(d, "g.pt")
    gen = Generator(GeneratorConfig(),
                    generator=torch.Generator().manual_seed(3))
    torch.save({"g_ema": gen.state_dict()}, gpath)
    del gen
    results = os.path.join(d, "results")
    zero_launches()
    t0 = time.perf_counter()
    with vis_calls("create_training_cluster_visuals", 13) as vis:
        state, generator, perceptual, pfn = train_cli.main(
            cars_argv(results, gpath, batch, CARS_ITERS, "--load_G_only",
                      "--vis_every", str(VIS_CYCLE), "--real_data_path",
                      reals))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    cfg = state.cfg
    print(f"cli.train, the cars run: {CARS_ITERS} iterations at batch "
          f"{batch} ({2 * batch * CARS_HEADS} streams a step) with the cold "
          f"start in {seconds:.1f} s; launches {launches}")
    check(cfg.t.num_heads == CARS_HEADS and cfg.flips
          and cfg.padding_mode == "reflection" and cfg.sample_from_full_res
          and cfg.loss_fn == "lpips" and cfg.ll.n_comps == 5
          and cfg.ll.inject_index == 6, f"cars config {cfg}")
    # the cluster visuals at iteration 0: two K1 in each of the reals'
    # loader batches (62 a batch) and of the fakes' chunks (62 a chunk),
    # and in the fake visuals
    chunks = -(-VIS_REALS // (VIS_BATCH // CARS_HEADS))
    check([c[0] for c in vis] == [0] and vis[0][3] == 2 * (2 * chunks + 1),
          f"the cars visuals ran at {[c[0] for c in vis]} with K1 "
          f"{[c[3] for c in vis]}, expected once, at 0, with "
          f"{2 * (2 * chunks + 1)}")
    vis_k1 = vis[0][3]
    check(launches["mipmap_sample"] == 2 * CARS_ITERS + vis_k1
          and launches["mipmap_sample_dcoords"] == 2 * CARS_ITERS
          and sum(launches.values()) == 4 * CARS_ITERS + vis_k1,
          "expected 2 K1 and 2 K3 launches per cars step")
    run_dir = os.path.join(results, "cars")
    check_grids(run_dir, ["sample", "transformed_sample", "truncated_sample",
                          "mean_EMA_transformed_real_sample",
                          "mean_generated_EMA_transformed_assigned"]
                + [f"EMA_head_{k}" for k in range(CARS_HEADS)], [0])
    head_grids = sorted(f for f in os.listdir(run_dir)
                        if f.startswith("generated_EMA_assigned_head_"))
    check(head_grids, "no head's assigned fakes were drawn")
    ckpt = os.path.join(results, "cars", "checkpoints",
                        f"{str(CARS_ITERS).zfill(7)}.pt")
    check(os.path.getsize(ckpt) > 0, "cli.train wrote no cars checkpoint")
    # The card is held against the CPU path at the state cli.train wrote.
    # The steps below go on training the random weights, and within ten
    # steps the similarity head zooms out until every level is the top
    # one; there a float32 step is ill-conditioned on any device, as a
    # relative rounding of the scale moves samples by whole texels.
    t_cli, ll_cli = copy.deepcopy(state.t), copy.deepcopy(state.ll)
    rng = torch.Generator(dev).manual_seed(5)
    assigned = []

    def step():
        z = torch.randn(batch, cfg.g.style_dim, generator=rng, device=dev)
        m = train_step(state, generator, pfn, z, 0.5, 1e-3, 1e-2, rng=rng)
        assigned.append(m.pop("assignments"))
        return m

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    part = CARS_TIMED // SUBWINDOWS
    ms = timed_parts(lambda w: [step() for _ in range(part)],
                     lambda m: check(all(math.isfinite(float(v))
                                         for v in m.values()),
                                     "a cars step is not finite"))
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    total = torch.cuda.get_device_properties(dev).total_memory / 2 ** 30
    rate = batch * CARS_TIMED / (sum(ms) / 1e3)
    counts = torch.bincount(torch.cat(assigned).cpu(),
                            minlength=2 * CARS_HEADS).tolist()
    print(f"cars step, batch {batch}: {rate:.2f} imgs/s over {CARS_TIMED} "
          f"steps in {sum(ms) / 1e3:.2f} s (in {SUBWINDOWS} parts: "
          f"{', '.join(f'{batch * part / (t / 1e3):.2f}' for t in ms)}), "
          f"{sum(ms) / CARS_TIMED:.1f} ms a step, peak memory of a step "
          f"{peak:.2f} GiB of {total:.2f}; the fakes' heads and flips over "
          f"the steps {counts} [{card}]")
    cycle = VIS_CYCLE * batch / rate
    print(f"cars vis call at iteration 0 (n_sample {VIS_SAMPLES}, "
          f"vis_batch_size {VIS_BATCH // CARS_HEADS} a head, n_mean "
          f"{VIS_REALS}, {chunks} chunks of fakes at "
          f"{2 * CARS_HEADS * (VIS_BATCH // CARS_HEADS)} streams): "
          f"{vis[0][1]:.2f} s, peak memory {vis[0][2]:.2f} GiB of "
          f"{total:.2f}, {vis_k1} K1 launches; grids {', '.join(head_grids)}; "
          f"a {VIS_CYCLE}-iteration cycle at {rate:.2f} imgs/s takes "
          f"{cycle:.0f} s, the vis call {vis[0][1] / cycle:.4%} of it "
          f"[{card}]")
    errs, rows = cars_kernels(state, step, card)
    prof = profiled(lambda: step())
    print_groups(f"step of the cars run at batch {batch}, 1 step", 1,
                 *kernel_groups(prof, STEP_GROUPS), card, top=8)
    ties, _ = cluster_card_vs_cpu_step(cfg, t_cli, ll_cli, generator,
                                       perceptual, dev)
    del t_cli, ll_cli
    return (state, generator, perceptual, pfn, ckpt, launches, rate, peak,
            errs, rows, ties, vis[0][1:3])


def cls_argv(results, ckpt, batch, iters):
    """lsun_cars_cluster_classifier.sh's flags at ``batch``."""
    return cars_argv(results, ckpt, batch, iters, "--period", "50000",
                     "--exp-name", "cars_cls")


def classifier_phase(dev, card, d, state, generator, perceptual, pfn, ckpt,
                     batch):
    """cli.train_cluster_classifier on the cars checkpoint, its rate, the
    checkpoint loaded back, and one step on the card against the CPU path.
    Returns the path of classifier.pt, the launches and the rate."""
    cfg = state.cfg
    results = os.path.join(d, "results")
    zero_launches()
    t0 = time.perf_counter()
    classifier, metrics = cls_cli.main(cls_argv(results, ckpt, batch,
                                                CLS_ITERS))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    print(f"cli.train_cluster_classifier: {CLS_ITERS} iterations at batch "
          f"{batch} in {seconds:.1f} s, cross-entropy "
          f"{float(metrics['cross_entropy']):.4f}, acc@1 "
          f"{float(metrics['acc@1']):.3f}, labels' shares "
          f"{[round(float(c), 3) for c in metrics['gt_counts']]}; launches "
          f"{launches}")
    check(launches["mipmap_sample"] == 2 * CLS_ITERS
          and sum(launches.values()) == 2 * CLS_ITERS,
          "expected 2 K1 launches per classifier step")
    path = os.path.join(results, "cars_cls", "checkpoints", "classifier.pt")
    model, mcfg, loaded = load_stn(path, supersize=256, device=dev,
                                   load_classifier=True)
    check(mcfg.num_heads == CARS_HEADS and loaded is not None
          and loaded.cfg.num_heads == 2 * CARS_HEADS
          and all(torch.equal(a, b) for a, b in zip(
              loaded.state_dict().values(),
              classifier.state_dict().values())),
          "classifier.pt does not load back through load_stn")
    print(f"classifier.pt loads back through load_stn(load_classifier=True):"
          f" {mcfg.num_heads} heads, {loaded.cfg.num_heads} logits, "
          f"weights equal")
    trainer = ClassifierTrainer(cfg, classifier, generator, state.t_ema,
                                state.ll, pfn)
    rng = torch.Generator(dev).manual_seed(6)

    def cls_step():
        z = torch.randn(batch, cfg.g.style_dim, generator=rng, device=dev)
        return trainer.step(z, 1e-3, rng=rng)

    cls_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ms = timed_parts(lambda w: [cls_step()],
                     lambda m: check(math.isfinite(float(
                         m["cross_entropy"])), "a classifier step is not "
                         "finite"))
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    rate = batch * SUBWINDOWS / (sum(ms) / 1e3)
    print(f"classifier trainer, batch {batch}: {rate:.2f} imgs/s over "
          f"{SUBWINDOWS} steps in {sum(ms) / 1e3:.2f} s, peak memory of a "
          f"step {peak:.2f} GiB [{card}]")

    # one step on the card and on the CPU path, from copies, at batch 2
    g = torch.Generator().manual_seed(12)
    z = torch.randn(2, cfg.g.style_dim, generator=g)
    noise = [[torch.randn(s, generator=g) for s in cfg.g.noise_shapes(b)]
             for b in (2, 2 * CARS_HEADS)]
    loss = make_perceptual_loss(cfg.loss_fn)
    runs = []
    for dv in (dev, torch.device("cpu")):
        lp = copy.deepcopy(perceptual).to(dv)
        tr = ClassifierTrainer(
            dataclasses.replace(cfg, batch=2),
            copy.deepcopy(classifier).to(dv), copy.deepcopy(generator).to(dv),
            copy.deepcopy(state.t_ema).to(dv), copy.deepcopy(state.ll).to(dv),
            lambda x, y, lp=lp: loss(lp, x, y))
        runs.append(tr.step(z.to(dv), 1e-3,
                            noise=[[n.to(dv) for n in ns] for ns in noise]))
    xent = [float(r["cross_entropy"]) for r in runs]
    labels = [r["labels"].cpu().tolist() for r in runs]
    rel = abs(xent[0] - xent[1]) / abs(xent[1])
    print(f"card vs CPU path, a classifier step at batch 2: labels "
          f"{labels[0]} vs {labels[1]}; cross-entropy {xent[0]:.6f} vs "
          f"{xent[1]:.6f} (relative {rel:.3e})")
    check(labels[0] == labels[1], "the classifier's labels differ from the "
          "CPU path")
    check(rel <= 1e-4, "the classifier's cross-entropy differs from the CPU "
          "path")
    return path, launches, rate, peak


def write_averages(d, n, size=256):
    """Average congealed images of the clusters, ...cluster0.png to
    ...cluster{n-1}.png, as smooth images."""
    from PIL import Image
    imgs = smooth_images(n, torch.Generator().manual_seed(14)).numpy()
    for k, im in enumerate(imgs):
        Image.fromarray(np.round((im + 1) * 127.5).astype(np.uint8)
                        .transpose(1, 2, 0)).save(
            os.path.join(d, f"avg_cluster{k}.png"))
    return os.path.join(d, "avg_cluster0.png")


def cluster_ar(dev, card, d, path):
    """The AR apps with the cars STN and its classifier (each frame through
    its one assigned head): frames/s at the eval batch, the
    cluster-activity video, propagate_to_images with and without a
    cluster, the kernels of a batch against their plain versions, and the
    card against the CPU path on 2 frames. Returns the launches and the
    errors."""
    model, _, classifier = load_stn(path, supersize=256, device=dev,
                                    load_classifier=True)
    cpu_model, _, cpu_classifier = load_stn(path, supersize=256,
                                            device="cpu",
                                            load_classifier=True)
    label, rgba = synthetic_label()
    label_png = write_label(rgba, d)
    average = write_averages(d, CARS_HEADS)
    frames = smooth_images(AR_FRAMES, torch.Generator().manual_seed(13)) \
        .numpy()
    kw = dict(classifier=classifier)

    zero_launches()
    check_ar(ar_run(model, frames[:AR_BATCH], label, **kw), AR_BATCH)
    seconds = []
    for _ in range(2):
        t0 = time.perf_counter()
        result = ar_run(model, frames, label, **kw)
        seconds.append(time.perf_counter() - t0)
        check_ar(result, AR_FRAMES)
    rate = 2 * AR_FRAMES / sum(seconds)
    t0 = time.perf_counter()
    result = ar_run(model, frames[:AR_BATCH], label, average_path=average,
                    out_dir=os.path.join(d, "mr"), **kw)
    average_s = time.perf_counter() - t0
    check_ar(result, AR_BATCH)
    frames_avg = result["average_frames"]
    check(len(frames_avg) == AR_BATCH and frames_avg[0].shape == (518, 518, 3)
          and os.path.getsize(os.path.join(d, "mr", "average.mp4")) > 0,
          "the cluster-activity video")
    with recorded(mipmap_ops, "mipmap_sample") as k1, \
            recorded(grid_sample_ops, "grid_sample_cuda") as k2, \
            recorded(splat_ops, "splat2d_pair_cuda") as k6:
        check_ar(ar_run(model, frames[:AR_BATCH], label, **kw), AR_BATCH)
    check(len(k1) == 4 and len(k2) == 1 and len(k6) == 1,
          f"an AR batch with the classifier launched K1 {len(k1)}, K2 "
          f"{len(k2)}, K6 {len(k6)} times; expected 4, 1 and 1")
    errs = ar_kernels_vs_plain(k1, k2, k6)
    for cluster in (None, 1):
        check_images(propagate_to_images(
            model, frames[:AR_BATCH], label_path=label_png, sigma=AR_SIGMA,
            opacity=1.0, batch=AR_BATCH, objects=True, classifier=classifier,
            cluster=cluster), AR_BATCH)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    batches = 1 + 2 * AR_FRAMES // AR_BATCH + 2 + 2
    # and K6 once for each cluster's average image of the video
    check(launches["mipmap_sample"] == 4 * batches
          and launches["grid_sample"] == batches
          and launches["splat"] == batches + CARS_HEADS
          and sum(launches.values()) == 6 * batches + CARS_HEADS,
          f"the AR path with the classifier launched {launches}, expected "
          "K1 4, K2 1 and K6 1 a batch and K6 once for each average image")
    print(f"AR with the classifier: {rate:.1f} frames/s over "
          f"{2 * AR_FRAMES} frames at batch {AR_BATCH} in "
          f"{sum(seconds):.2f} s "
          f"({', '.join(f'{AR_FRAMES / t:.1f}' for t in seconds)}); a batch with the cluster-activity video {average_s:.2f} s; "
          f"{batches} batches, launches {launches}; K1, K2 and K6 of a batch "
          f"against the plain versions: max abs err K1 "
          f"{errs['mipmap_sample']:.3e}, K2 {errs['grid_sample']:.3e}, K6 "
          f"{errs['splat']:.3e} [{card}]")

    # 2 frames on the card and on the CPU path
    x = frames[:2]
    with torch.inference_mode():
        logits = cpu_classifier(torch.from_numpy(x))
        picks = [determine_flips(m, torch.from_numpy(x).to(
            next(m.parameters()).device), classifier=c)
            for m, c in ((model, classifier), (cpu_model, cpu_classifier))]
    top = logits.sort(dim=1).values
    gap = float(((top[:, -1] - top[:, -2]) / top[:, -1].abs()).min())
    flips = [p[1].cpu().ravel().tolist() for p in picks]
    clusters = [p[3].cpu().tolist() for p in picks]
    got = ar_run(model, x, label, save_correspondences=True, **kw)
    ref = ar_run(cpu_model, x, label, save_correspondences=True,
                 classifier=cpu_classifier)
    pt = float(np.abs(got["correspondences"] - ref["correspondences"]).max())
    cong = float(np.abs(got["congealed"] - ref["congealed"]).max())
    prop = np.abs(got["propagated"] - ref["propagated"])
    print(f"card vs CPU path, AR with the classifier on 2 frames: clusters "
          f"{clusters[0]} vs {clusters[1]}, flips {flips[0]} vs {flips[1]} "
          f"(smallest relative gap of the top two logits {gap:.3e}); points "
          f"{pt:.3e} px, congealed frames {cong:.3e}, propagated frames mean "
          f"{prop.mean():.3e} max {prop.max():.3e}")
    check(clusters[0] == clusters[1] and flips[0] == flips[1],
          "AR with the classifier: the clusters or flips differ from the "
          "CPU path")
    check(pt <= AR_PT_TOL and cong <= OUT_TOL
          and prop.mean() <= AR_PROP_MEAN_TOL,
          "AR with the classifier differs from the CPU path")
    for cluster in (None, 1):
        got, ref = (propagate_to_images(
            m, x, label_path=label_png, sigma=AR_SIGMA, opacity=1.0,
            batch=AR_BATCH, objects=True, classifier=c, cluster=cluster)
            for m, c in ((model, classifier), (cpu_model, cpu_classifier)))
        cong = float(np.abs(got["congealed"] - ref["congealed"]).max())
        prop = np.abs(got["propagated"] - ref["propagated"])
        print(f"card vs CPU path, propagate_to_images with the classifier, "
              f"cluster {cluster}, on 2 images: congealed {cong:.3e}, "
              f"propagated mean {prop.mean():.3e} max {prop.max():.3e}")
        check(cong <= OUT_TOL and prop.mean() <= AR_PROP_MEAN_TOL,
              "propagate_to_images with the classifier differs from the CPU "
              "path")
    return launches, errs, rate


def time_kmeans(generator, pfn, dev, card):
    """One whole K-Means++ (4 centroids) at KMEANS_LATENTS latents."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    centroids = kmeans_plusplus(generator, pfn, CARS_HEADS, KMEANS_LATENTS,
                                torch.Generator(dev).manual_seed(15),
                                inject_index=6)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check(centroids.shape == (CARS_HEADS, 512)
          and bool(torch.isfinite(centroids).all()), "kmeans++ centroids")
    print(f"kmeans++: {CARS_HEADS} centroids from {KMEANS_LATENTS} latents "
          f"(256 px, lpips) in {seconds:.2f} s [{card}]")
    return seconds


def cluster(dev, card, reals):
    """The cluster phase: the cars run, its classifier, the AR apps with
    it. Returns the main path's launches (each part counted from zero just
    before it), the kernels' errors and the figures of the report."""
    start = time.perf_counter()
    batch = CARS_BATCH
    d = tempfile.mkdtemp()
    (state, generator, perceptual, pfn, ckpt, train_launches, rate, peak,
     errs, rows, ties, cars_vis) = cars_train(dev, card, d, batch, reals)
    path, cls_launches, cls_rate, cls_peak = classifier_phase(
        dev, card, d, state, generator, perceptual, pfn, ckpt, CLS_BATCH)
    kmeans_s = time_kmeans(generator, pfn, dev, card)
    del state, perceptual
    ar_launches, ar_errs, ar_rate = cluster_ar(dev, card, d, path)
    for k, v in ar_errs.items():
        errs[k] = max(errs.get(k, 0.0), v)
    launches = {k: train_launches[k] + cls_launches[k] + ar_launches[k]
                for k in LAUNCHES}
    shutil.rmtree(d)
    print(f"cluster phase: {time.perf_counter() - start:.1f} s; cars "
          f"{rate:.2f} imgs/s at batch {batch}, peak {peak:.2f} GiB; "
          f"classifier {cls_rate:.2f} imgs/s at batch {CLS_BATCH}, peak "
          f"{cls_peak:.2f} GiB; AR "
          f"with the classifier {ar_rate:.1f} frames/s; kmeans++ "
          f"{kmeans_s:.2f} s; near-tie assignments {ties}; launches "
          f"{launches} [{card}]")
    return launches, errs, rows, (rate, peak, cls_rate, cls_peak, ar_rate,
                                  cars_vis)


# The precision phase: --compute_dtype bfloat16, the JAX package's training
# precision (both G passes' synthesis and the perceptual trunk in bfloat16;
# the STN, the warps and their kernels in float32), on the cats run at
# TRAIN_BATCH and the cars run at CARS_BATCH, each for BF16_ITERS
# iterations of cli.train and then timed as the float32 runs are; and a
# served congeal forward at batch 128 with ComposedSTNConfig.compute_dtype
# "bfloat16" (the encoders' convs in bfloat16). The gates were set from the
# CPU tests' readings (tests/test_torch_bf16.py; PERF.md) before the first
# card call. BF16_GATES, BF16_CLUSTER_GATES: a batch-2 bfloat16 step, cats
# and cars, on the card against the port's bfloat16 CPU path (loss terms
# relative, each gradient tensor over its largest value, all gradients in
# relative L2): the gates of the port's bfloat16 steps against JAX's on
# the CPU (unimodal, clustered); BF16_TIE, the relative gap of two
# distances under which two bfloat16 paths may assign a fake apart, is
# that test's. The cats step is held where the float32 one is (train: the
# state the float32 cli.train run wrote, the identity init). Its tensor
# gate fails on the card (ROADMAP Queue 3, PERF.md): its worst tensor is
# printed beside the gate and not held; its loss terms and L2 are held.
# BF16_VS_F32: the cats step in bfloat16 on the card against its own
# float32 step (loss terms, all gradients in L2), as the CPU test holds the
# port's. BF16_CONGEAL_TOL: the bfloat16 congeal forward's grids and flows
# against the float32 forward's, on smooth images (its images printed).
BF16_ITERS = 2
BF16_TIMED = 16  # cats steps in the timed window (about 5.6 s in bf16)
BF16_TIE = 2e-2
BF16_GATES = (1e-2, 0.1, 3e-2)
BF16_CLUSTER_GATES = (1e-2, 0.25, 8e-2)
BF16_VS_F32 = (5e-2, 0.25)
BF16_CONGEAL_TOL = 0.1


def bf16_check(card, cpu, gates, what, hold_tensors=True):
    """A bfloat16 step's (loss terms, gradients) on the card against the
    CPU path's: loss terms within ``gates[0]`` relative, each gradient
    tensor within ``gates[1]`` of its largest value, all gradients within
    ``gates[2]`` in relative L2 norm. With ``hold_tensors`` False the
    worst tensor is printed beside its gate and not held."""
    term_tol, grad_tol, l2_tol = gates
    rel, worst, l2 = compare_steps(card, cpu)
    over = worst[0] > grad_tol
    held = "" if hold_tensors else ", printed, not held"
    print(f"card vs CPU path, {what}: loss terms {card[0]} vs {cpu[0]} "
          f"(relative {rel:.3e}, gate {term_tol}); worst gradient "
          f"{worst[1]} at {worst[0]:.3e} of its largest value "
          f"({'OVER' if over else 'within'} its gate {grad_tol}{held}); all "
          f"gradients {l2:.3e} in relative L2 norm (gate {l2_tol})")
    check(rel <= term_tol, f"{what}: a loss term differs from the CPU path")
    check(l2 <= l2_tol, f"{what}: the gradients differ from the CPU path")
    check(not (hold_tensors and over), f"{what}: a gradient tensor differs "
          "from the CPU path")


def bf16_card_vs_cpu_step(cfg, t, ll, generator, perceptual, dev, what,
                          f32_card):
    """The batch-2 cats step of ``card_vs_cpu_step`` in bfloat16, on the
    card against the CPU path within BF16_GATES (the worst tensor printed,
    not held), and against the card's float32 step ``f32_card`` (same
    state, z and noise) within BF16_VS_F32."""
    bf16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    z, noise = step_batch2(cfg)
    card, cpu = [step_grads(bf16, t, ll, generator, perceptual, d, z, noise)
                 for d in (dev, torch.device("cpu"))]
    bf16_check(card, cpu, BF16_GATES,
               f"one bfloat16 train step from the {what} at batch 2",
               hold_tensors=False)
    rel, worst, l2 = compare_steps(card, f32_card)
    print(f"card, that bfloat16 step against its float32 one: loss terms "
          f"relative {rel:.3e}; worst gradient {worst[1]} at {worst[0]:.3e} "
          f"of its largest value; all gradients {l2:.3e} in relative L2 "
          f"norm (gates {BF16_VS_F32[0]}, {BF16_VS_F32[1]} in L2)")
    check(rel <= BF16_VS_F32[0] and l2 <= BF16_VS_F32[1],
          f"{what}: the bfloat16 step strays from the float32 one")


def operand_dtypes(calls):
    """The dtypes of the tensors that recorded kernel calls took."""
    return {t.dtype for args, _ in calls for a in args
            for t in (a if isinstance(a, tuple) else (a,))
            if torch.is_tensor(t)}


def bf16_cli(argv, results, exp, iters, dev):
    """python -m gangealing_torch.cli.train in process on ``argv`` (with
    --compute_dtype bfloat16): K1 and K3 twice a step and nothing else,
    finite scalars, the last checkpoint resumed into a fresh state.
    Returns the run's state, G, perceptual model and function, and its
    launches."""
    zero_launches()
    t0 = time.perf_counter()
    state, generator, perceptual, pfn = train_cli.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    print(f"cli.train --compute_dtype bfloat16, the {exp} run: {iters} "
          f"iterations at batch {state.cfg.batch} with the cold start in "
          f"{seconds:.1f} s; launches {launches}")
    check(state.cfg.compute_dtype == "bfloat16", f"{exp}: cli.train ran "
          f"{state.cfg.compute_dtype}")
    check(launches["mipmap_sample"] == 2 * iters
          and launches["mipmap_sample_dcoords"] == 2 * iters
          and sum(launches.values()) == 4 * iters,
          f"{exp}: expected 2 K1 and 2 K3 launches per bfloat16 step")
    run_dir = os.path.join(results, exp)
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        scalars = [json.loads(line) for line in f if line.strip()]
    check({s["step"] for s in scalars} == set(range(1, iters + 1))
          and all(math.isfinite(s["value"]) for s in scalars),
          f"{exp}: the bfloat16 run's scalars miss a step or are not finite")
    check_resume(state, os.path.join(run_dir, "checkpoints",
                                     f"{str(iters).zfill(7)}.pt"), dev)
    return state, generator, perceptual, pfn, launches


def bf16_kernels(step, what):
    """Each K1 and K3 launch of one bfloat16 step held against its plain
    version; every operand they took is float32."""
    with recorded(mipmap_ops, "mipmap_sample") as k1, \
            recorded(mipmap_ops, "mipmap_sample_dcoords") as k3:
        step()
    check(len(k1) == 2 and len(k3) == 2, f"a bfloat16 {what} step did not "
          "launch K1 and K3 twice")
    dtypes = operand_dtypes(k1) | operand_dtypes(k3)
    check(dtypes == {torch.float32}, f"K1 or K3 took {dtypes} in a "
          f"bfloat16 {what} step")
    errs = {}
    with torch.no_grad():
        hold("mipmap_sample", [(out, _sample_pyramid(*a)) for a, out in k1],
             errs)
    hold("mipmap_sample_dcoords", backward_pairs(k3, k3_graph), errs)
    print(f"K1 and K3 launches of a bfloat16 {what} step, float32 operands, "
          f"held against the plain versions: max abs err K1 "
          f"{errs['mipmap_sample']:.3e}, K3 "
          f"{errs['mipmap_sample_dcoords']:.3e}")
    return errs


def bf16_cats(dev, card, d, gpath, f32_rate, f32_peak):
    """The cats run in bfloat16: cli.train, its kernels, imgs/s and the
    peak of a step beside this run's float32 ones, and where the time
    goes (its batch-2 gates are held in ``train``)."""
    results = os.path.join(d, "cats_bf16")
    state, generator, _, pfn, launches = bf16_cli(
        cats_argv(results, gpath, BF16_ITERS, "--vis_every", "0",
                  "--compute_dtype", "bfloat16"),
        results, "smoke", BF16_ITERS, dev)
    cfg = state.cfg
    rng = torch.Generator(dev).manual_seed(5)

    def step():
        z = torch.randn(TRAIN_BATCH, cfg.g.style_dim, generator=rng,
                        device=dev)
        return train_step(state, generator, pfn, z, 0.5, 1e-3, 1e-2, rng=rng)

    errs = bf16_kernels(step, "cats")
    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    part = BF16_TIMED // SUBWINDOWS
    ms = timed_parts(lambda w: [step() for _ in range(part)],
                     lambda m: check(all(math.isfinite(float(v))
                                         for v in m.values()),
                                     "a bfloat16 cats step is not finite"))
    rate = TRAIN_BATCH * BF16_TIMED / (sum(ms) / 1e3)
    parts = ", ".join(f"{TRAIN_BATCH * part / (t / 1e3):.1f}" for t in ms)
    print(f"bfloat16 cats step, batch {TRAIN_BATCH}: {rate:.1f} imgs/s over "
          f"{BF16_TIMED} steps in {sum(ms) / 1e3:.2f} s (in {SUBWINDOWS} "
          f"parts: {parts}), "
          f"peak memory of a step {peak:.2f} GiB; float32 in this run "
          f"{f32_rate:.1f} imgs/s, {f32_peak:.2f} GiB [{card}]")
    prof = profiled(lambda: [step() for _ in range(2)])
    print_groups(f"step at batch {TRAIN_BATCH} in bfloat16, 2 steps", 2,
                 *kernel_groups(prof, STEP_GROUPS), card, top=8)
    return launches, errs, rate, peak


def bf16_cars(dev, card, d, gpath, f32_rate, f32_peak):
    """The cars run in bfloat16 at CARS_BATCH: cli.train, its kernels,
    imgs/s and the peak over the timed steps beside this run's float32
    ones, and the batch-2 clustered gate; the card's bfloat16 step against
    its float32 one printed."""
    results = os.path.join(d, "cars_bf16")
    state, generator, perceptual, pfn, launches = bf16_cli(
        cars_argv(results, gpath, CARS_BATCH, CARS_ITERS, "--load_G_only",
                  "--compute_dtype", "bfloat16"),
        results, "cars", CARS_ITERS, dev)
    cfg = state.cfg
    t_cli, ll_cli = copy.deepcopy(state.t), copy.deepcopy(state.ll)
    rng = torch.Generator(dev).manual_seed(5)

    def step():
        z = torch.randn(CARS_BATCH, cfg.g.style_dim, generator=rng,
                        device=dev)
        m = train_step(state, generator, pfn, z, 0.5, 1e-3, 1e-2, rng=rng)
        m.pop("assignments")
        return m

    errs = bf16_kernels(step, "cars")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    part = CARS_TIMED // SUBWINDOWS
    ms = timed_parts(lambda w: [step() for _ in range(part)],
                     lambda m: check(all(math.isfinite(float(v))
                                         for v in m.values()),
                                     "a bfloat16 cars step is not finite"))
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    total = torch.cuda.get_device_properties(dev).total_memory / 2 ** 30
    rate = CARS_BATCH * CARS_TIMED / (sum(ms) / 1e3)
    parts = ", ".join(f"{CARS_BATCH * part / (t / 1e3):.2f}" for t in ms)
    print(f"bfloat16 cars step, batch {CARS_BATCH}: {rate:.2f} imgs/s over "
          f"{CARS_TIMED} steps in {sum(ms) / 1e3:.2f} s (in {SUBWINDOWS} "
          f"parts: {parts}), "
          f"{sum(ms) / CARS_TIMED:.1f} ms a step, peak memory of a step "
          f"{peak:.2f} GiB of {total:.2f}; float32 in this run "
          f"{f32_rate:.2f} imgs/s, {f32_peak:.2f} GiB [{card}]")
    ties, (seed, bf16_run) = cluster_card_vs_cpu_step(
        cfg, t_cli, ll_cli, generator, perceptual, dev)
    z, noise = cluster_step_batch2(cfg, seed)
    f32_run = cluster_step_grads(
        dataclasses.replace(cfg, compute_dtype="float32"), t_cli, ll_cli,
        generator, perceptual, dev, z, noise)
    same = torch.equal(bf16_run[2], f32_run[2])
    rel, worst, l2 = compare_steps(bf16_run[:2], f32_run[:2])
    print(f"card, one bfloat16 clustered step against the float32 step from "
          f"the same state at batch 2 (z seed {seed}): assignments "
          f"{bf16_run[2].tolist()} vs {f32_run[2].tolist()}; loss terms "
          f"relative {rel:.3e}; worst gradient {worst[1]} at {worst[0]:.3e} "
          f"of its largest value; all gradients {l2:.3e} in relative L2 "
          f"norm{'' if same else ' (other assignments: not comparable)'} "
          f"[{card}]")
    return launches, errs, rate, peak, ties


def bf16_congeal(dev, card, f32_rate):
    """The flagship's congeal forward with its encoders in bfloat16 at
    batch 128 on smooth images: its two K1 launches on float32 operands
    held against the plain version, its images, grids and flows against
    the float32 forward's, imgs/s over about 5 s beside the float32 rate
    of this run's serve phase. Returns its launches, errors and rate."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "stn.pt")
        make_checkpoint(path)
        model, cfg = load_stn(path, supersize=256, device=dev)
    b = 128
    bf16 = ComposedSTN(dataclasses.replace(cfg, compute_dtype="bfloat16"),
                       device=dev).eval()
    bf16.load_state_dict(model.state_dict())
    requests = [smooth_images(b, torch.Generator().manual_seed(30 + i)).to(dev)
                for i in range(REQUESTS)]
    with recorded(mipmap_ops, "mipmap_sample") as k1:
        got = congeal(bf16, requests[0])
    check(len(k1) == 2, "the bfloat16 congeal forward did not launch K1 "
          "twice")
    check(operand_dtypes(k1) == {torch.float32}, "K1 took "
          f"{operand_dtypes(k1)} in the bfloat16 congeal forward")
    errs = {}
    with torch.no_grad():
        hold("mipmap_sample", [(out, _sample_pyramid(*a)) for a, out in k1],
             errs)
    ref = congeal(model, requests[0])
    diff = [float((a - r).abs().max()) for a, r in zip(got[:3], ref[:3])]
    print(f"bfloat16 congeal forward at batch {b} against the float32 one, "
          f"smooth images: out {diff[0]:.3e}, grid {diff[1]:.3e}, flow "
          f"{diff[2]:.3e} (grid and flow gated at {BF16_CONGEAL_TOL}); its "
          f"K1 launches, float32 operands, held: max abs err "
          f"{errs['mipmap_sample']:.3e}")
    check(max(diff[1:]) <= BF16_CONGEAL_TOL,
          "the bfloat16 congeal forward strays from the float32 one")
    del got, ref, k1
    zero_launches()
    check_outputs(congeal(bf16, requests[1]), b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    check_outputs(congeal(bf16, requests[2]), b)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    part = TIMED[b] // SUBWINDOWS
    ms = timed_parts(
        lambda w: [congeal(bf16, requests[(w * part + i) % REQUESTS])
                   for i in range(part)],
        lambda r: check_outputs(r, b))
    launches = dict(LAUNCHES)
    check(launches["mipmap_sample"] == 2 * (TIMED[b] + 2)
          and sum(launches.values()) == launches["mipmap_sample"],
          f"the bfloat16 congeal forwards launched {launches}")
    rate = b * TIMED[b] / (sum(ms) / 1e3)
    print(f"bfloat16 congeal batch {b}: {rate:.1f} imgs/s over {TIMED[b]} "
          f"requests in {sum(ms) / 1e3:.2f} s (in {SUBWINDOWS} parts: "
          f"{', '.join(f'{b * part / (t / 1e3):.1f}' for t in ms)}), peak "
          f"memory of a request {peak:.2f} GiB; float32 in this run "
          f"{f32_rate:.1f} imgs/s [{card}]")
    return launches, errs, rate


def precision(dev, card, f32):
    """The precision phase. ``f32``: this run's float32 figures (cats
    imgs/s and peak, cars imgs/s and peak, congeal imgs/s at 128) to print
    beside. Returns the main path's launches (each part counted from zero
    just before it), the kernels' errors and the bfloat16 figures."""
    start = time.perf_counter()
    d = tempfile.mkdtemp()
    gpath = os.path.join(d, "g.pt")
    gen = Generator(GeneratorConfig(),
                    generator=torch.Generator().manual_seed(3))
    torch.save({"g_ema": gen.state_dict()}, gpath)
    del gen
    cats_launches, errs, cats_rate, cats_peak = bf16_cats(
        dev, card, d, gpath, *f32[:2])
    cars_launches, cars_errs, cars_rate, cars_peak, ties = bf16_cars(
        dev, card, d, gpath, *f32[2:4])
    congeal_launches, congeal_errs, congeal_rate = bf16_congeal(
        dev, card, f32[4])
    shutil.rmtree(d)
    for e in (cars_errs, congeal_errs):
        for k, v in e.items():
            errs[k] = max(errs.get(k, 0.0), v)
    launches = {k: cats_launches[k] + cars_launches[k] + congeal_launches[k]
                for k in LAUNCHES}
    print(f"precision phase: {time.perf_counter() - start:.1f} s; bfloat16 "
          f"cats {cats_rate:.1f} imgs/s, peak {cats_peak:.2f} GiB; cars "
          f"{cars_rate:.2f} imgs/s, peak {cars_peak:.2f} GiB; congeal "
          f"{congeal_rate:.1f} imgs/s; near-tie assignments {ties}; "
          f"launches {launches} [{card}]")
    return launches, errs, (cats_rate, cats_peak, cars_rate, cars_peak,
                            congeal_rate)


# The visualize phase: python -m gangealing_torch.cli.vis_correspondence in
# track mode at the reference's defaults (a stage of TRACK_LENGTH frames,
# the flip of 40, sigma 1.2, opacity 0.7, splat_batch 100, the first 4
# dataset images, 60 fps) with --vis_in_stages, --stage_flip and --objects,
# a fully opaque 256 px RGBA label (P = 65,536); the card against the CPU
# path on a TRACK_CHECK_LENGTH-frame track of 2 images with a disc label
# of radius TRACK_CHECK_RADIUS; the other modes once at VIS_MODE_LENGTH
# frames; cli.process_video on VIDEO_FRAMES frames of 256 px. Two patch
# picks whose distances to the point differ by under NN_TIE (twice the
# congeal gate on a grid) are a near tie, which the card and the CPU may
# decide apart.
TRACK_LENGTH = 60
TRACK_FLIP = 40
TRACK_IMAGES = 4
TRACK_CHECK_LENGTH = 4
TRACK_CHECK_RADIUS = 8
VIS_MODE_LENGTH = 20
VIDEO_FRAMES = 32
NN_TIE = 2 * GRID_TOL


def label_rgba(size=256, radius=None):
    """An RGBA label of smooth colours, opaque everywhere or in a centred
    disc of ``radius``."""
    yy, xx = np.mgrid[:size, :size]
    rgba = np.zeros((size, size, 4), np.uint8)
    rgba[..., 0] = 255 * xx // size
    rgba[..., 1] = 255 * yy // size
    rgba[..., 2] = 128 + np.round(127 * np.sin((xx + yy) / 23.0))
    c = (size - 1) / 2
    rgba[..., 3] = 255 if radius is None else np.where(
        (xx - c) ** 2 + (yy - c) ** 2 <= radius ** 2, 255, 0)
    return rgba


@contextlib.contextmanager
def stage_calls():
    """Time each _smooth_stage of the app made in the block (the card
    synchronised at both ends): (tracks points, frames, seconds, launches)
    a stage; and the arguments of the first stage that tracks."""
    fn = vc_app._smooth_stage
    calls, first = [], []

    def timed(*a, **kw):
        torch.cuda.synchronize()
        before = dict(LAUNCHES)
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        tracks = len(a) > 5 and a[5] is not None
        calls.append((tracks, a[3], time.perf_counter() - t0,
                      {k: LAUNCHES[k] - before[k] for k in LAUNCHES
                       if LAUNCHES[k] > before[k]}))
        if tracks and not first:
            first.append((a, kw))
        return out

    vc_app._smooth_stage = timed
    try:
        yield calls, first
    finally:
        vc_app._smooth_stage = fn


@contextlib.contextmanager
def nn_calls():
    """Record the inputs and picks of every patch search made in the
    block, on the host."""
    fn = vc_app.nearest_neighbor_within_patch
    calls = []

    def rec(grid, points, centers, patch_size):
        out = fn(grid, points, centers, patch_size)
        calls.append((grid.cpu(), points.cpu(), centers.cpu(), out.cpu()))
        return out

    vc_app.nearest_neighbor_within_patch = rec
    try:
        yield calls
    finally:
        vc_app.nearest_neighbor_within_patch = fn


def near_tie_tracks(card_calls, cpu_calls):
    """The patch searches of the card's track against the CPU path's, call
    by call: where the two picked apart from the same window, the picks'
    distances on the CPU path's grid must differ by under NN_TIE. Returns
    (those near-tie picks, the points whose last pick differs)."""
    check(len(card_calls) == len(cpu_calls),
          f"{len(card_calls)} patch searches on the card, "
          f"{len(cpu_calls)} on the CPU")
    ties = 0
    for (_, _, c_card, o_card), (grid, pts, c_cpu, o_cpu) in zip(
            card_calls, cpu_calls):
        first = (o_card != o_cpu).any(-1) & (c_card == c_cpu).all(-1)
        if not bool(first.any()):
            continue
        g = vc_app.pad_grid(grid)
        Hp, Wp = g.shape[1:3]
        for n, q in zip(*torch.nonzero(first, as_tuple=True)):
            def dist(xy):
                x = min(max(int(xy[0]) + 1, 0), Wp - 1)
                y = min(max(int(xy[1]) + 1, 0), Hp - 1)
                return float((g[n, y, x] - pts[n, q]).norm())
            d_card, d_cpu = dist(o_card[n, q]), dist(o_cpu[n, q])
            check(abs(d_card - d_cpu) <= NN_TIE,
                  f"the card's patch search picked {o_card[n, q].tolist()} "
                  f"against {o_cpu[n, q].tolist()}, distances {d_card} and "
                  f"{d_cpu}")
            ties += 1
    differ = int((card_calls[-1][3] != cpu_calls[-1][3]).any(-1).sum())
    return ties, differ


def track_card_vs_cpu(ckpt, reals, d, card):
    """A TRACK_CHECK_LENGTH-frame track of 2 images in stages with the flip
    and a disc label, on the card and on the port's CPU path: the
    congealing frames within 1 uint8 level, the patch searches equal but
    at counted near ties."""
    from PIL import Image
    label = os.path.join(d, "disc.png")
    Image.fromarray(label_rgba(radius=TRACK_CHECK_RADIUS)).save(label)
    dset = MultiResolutionDataset(reals, resolution=256)
    imgs = np.stack([dset[i] for i in range(2)])
    kw = dict(label_path=label, length=TRACK_CHECK_LENGTH,
              output_resolution=256, resolution=256, vis_in_stages=True,
              stage_flip=True, flip_length=TRACK_CHECK_LENGTH, objects=True)
    runs = []
    for dev in ("cuda", "cpu"):
        model, _ = load_stn(ckpt, supersize=256, device=dev)
        with nn_calls() as calls:
            frames, _ = vc_app.smoothly_congeal_and_propagate(model, imgs,
                                                              **kw)
        runs.append((frames, calls))
    (f_card, nn_card), (f_cpu, nn_cpu) = runs
    check(len(f_card) == len(f_cpu) == 3 * TRACK_CHECK_LENGTH,
          f"{len(f_card)} and {len(f_cpu)} congealing frames")
    level = max(int(np.abs(a.astype(int) - b.astype(int)).max())
                for a, b in zip(f_card, f_cpu))
    ties, differ = near_tie_tracks(nn_card, nn_cpu)
    points = int(nn_cpu[0][1].shape[1])
    print(f"card vs CPU path, a {TRACK_CHECK_LENGTH}-frame track of 2 images "
          f"in stages with the flip, {points} label points, "
          f"{len(nn_cpu)} patch searches: congealing frames within "
          f"{level} uint8 level(s); {ties} near-tie picks, {differ} points "
          f"whose last pick differs [{card}]")
    check(level <= 1, "the track's congealing frames differ from the CPU "
          "path by more than one level")


def region_points(coords, H, W, rx=64, ry=32):
    """The most points of one image that fall in one of K6's rx x ry pixel
    regions (or tiles): a lower bound on the length of its list."""
    x = coords[..., 0].floor().long()
    y = coords[..., 1].floor().long()
    ok = (x >= 0) & (x < W) & (y >= 0) & (y < H)
    n = torch.arange(coords.shape[0], device=coords.device)[:, None]
    cells = (n * ((H // ry) * (W // rx)) + (y // ry) * (W // rx)
             + x // rx)[ok]
    return int(torch.bincount(cells).max())


def process_video_split(video, out):
    """cli.process_video's work, part by part on the host clock: cv2's
    decodes, each frame's centre crop and its PNG encode (the two halves
    of data/prepare.py::resize_and_convert) and the LMDB's write.
    Returns the seconds by part."""
    import cv2
    import io
    from PIL import Image
    parts = dict.fromkeys(("decode", "crop", "PNG encode", "LMDB write"),
                          0.0)
    cap = cv2.VideoCapture(video)
    items = {}
    while True:
        t0 = time.perf_counter()
        ok, frame = cap.read()
        t1 = time.perf_counter()
        parts["decode"] += t1 - t0
        if not ok:
            break
        img = center_crop(Image.fromarray(frame[:, :, ::-1]), 256)
        t2 = time.perf_counter()
        buf = io.BytesIO()
        img.save(buf, format="png", quality=100)
        items[f"256-{len(items):05d}".encode()] = buf.getvalue()
        t3 = time.perf_counter()
        parts["crop"] += t2 - t1
        parts["PNG encode"] += t3 - t2
    cap.release()
    t0 = time.perf_counter()
    write_lmdb(out, items)
    parts["LMDB write"] = time.perf_counter() - t0
    return parts


def visualize(dev, card, reals):
    """The visualize phase (see TRACK_LENGTH). Returns the launches of its
    main path (each CLI run counted from zero just before it), the
    kernels' errors and (track frames/s, the stage's idle share)."""
    from PIL import Image
    start = time.perf_counter()
    d = tempfile.mkdtemp()
    ckpt = os.path.join(d, "stn.pt")
    make_checkpoint(ckpt)
    label = os.path.join(d, "label.png")
    Image.fromarray(label_rgba()).save(label)
    out = os.path.join(d, "track")
    argv = ["--ckpt", ckpt, "--real_data_path", reals, "--real_size", "256",
            "--label_path", label]
    zero_launches()
    with stage_calls() as (stages, first), \
            recorded(mipmap_ops, "mipmap_sample") as k1, \
            recorded(grid_sample_ops, "grid_sample_cuda") as k2, \
            recorded(splat_ops, "splat2d_pair_cuda") as k6:
        t0 = time.perf_counter()
        congeal_frames, prop_frames = vis_cli.main(
            argv + ["--objects", "--length", str(TRACK_LENGTH),
                    "--vis_in_stages", "--stage_flip", "--out", out])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    n_frames = len(congeal_frames) + len(prop_frames)
    check(len(congeal_frames) == TRACK_FLIP + 2 * TRACK_LENGTH
          and len(prop_frames) == TRACK_FLIP + 2 * TRACK_LENGTH,
          f"{len(congeal_frames)} congealing and {len(prop_frames)} "
          "propagation frames")
    check(congeal_frames[0].shape == (518, 518, 3),
          f"frames of {congeal_frames[0].shape}")
    for name in ("smoothly_congeal.mp4", "smoothly_propagate.mp4",
                 "smooth_correspondence.mp4"):
        check(os.path.getsize(os.path.join(out, name)) > 0,
              f"vis_correspondence wrote no {name}")
    T_N = 2 * TRACK_LENGTH * TRACK_IMAGES
    check(len(k2) == 1 and len(k6) == 1 + -(-T_N // 100)
          and len(k1) == launches["mipmap_sample"]
          and launches["splat"] == len(k6),
          f"the track launched K1 {len(k1)}, K2 {len(k2)}, K6 {len(k6)}; "
          f"counts {launches}")
    region = max((region_points(a[0], a[4], a[5]) for a, _ in k6),
                 default=0)
    tile = max((region_points(a[0], a[4], a[5], 16, 16) for a, _ in k6),
               default=0)
    errs = {}
    with torch.inference_mode():
        hold("mipmap_sample", [(o, _sample_pyramid(*a)) for a, o in k1],
             errs)
        hold("grid_sample", [(o, grid_sample(a[0], a[1], padding_mode=a[2]))
                             for a, o in k2], errs)
    hold_pairs(k6, errs)
    del k1, k2, k6
    tracked = [c for c in stages if c[0]]
    per_stage = tracked[0][3]
    print(f"vis_correspondence track ({TRACK_IMAGES} images, a dense "
          f"label of {256 * 256} points, stages of {TRACK_LENGTH} frames "
          f"and the flip of {TRACK_FLIP}, in stages, objects): {n_frames} "
          f"frames in {seconds:.2f} s, {n_frames / seconds:.1f} frames/s; "
          f"{len(stages)} stages, the tracked ones "
          f"{', '.join(f'{c[2]:.2f}' for c in tracked)} s "
          f"({TRACK_LENGTH / np.mean([c[2] for c in tracked]):.1f} frames/s), "
          f"launches a tracked stage {per_stage}; launches {launches}; "
          f"K6 over up to {region} points a 64 x 32 region and {tile} a "
          f"16 x 16 tile (its lists hold 1,536 and 192); max abs err vs "
          f"plain K1 "
          f"{errs['mipmap_sample']:.3e}, K2 {errs['grid_sample']:.3e}, K6 "
          f"{errs['splat']:.3e} [{card}]")
    check(tile > 192, "the dense label's splat did not overflow K6's "
          "tile list")

    # one tracked stage under the profiler: the device's idle share
    (a, kw), = first
    groups = (("K1 mipmap_sample", ("mipmap_pyramid_fwd",)),
              ("patch search gathers", ("gather",)),
              ("reductions and argmin", ("reduce", "argmin")),
              ("copies to the host", ("memcpy",)))
    prof = profiled(lambda: vc_app._smooth_stage(*a, **kw))
    by_group, busy, span, other = kernel_groups(prof, groups)
    print_groups(f"stage of the track, {TRACK_LENGTH} frames", 1, by_group,
                 busy, span, other, card, top=4)
    idle = 1 - busy / span

    track_card_vs_cpu(ckpt, reals, d, card)

    for mode in ("congeal", "propagate", "average"):
        zero_launches()
        t0 = time.perf_counter()
        frames = vis_cli.main(argv + ["--mode", mode, "--length",
                                      str(VIS_MODE_LENGTH), "--out", out])
        torch.cuda.synchronize()
        mode_s = time.perf_counter() - t0
        check(len(frames) == VIS_MODE_LENGTH
              and os.path.getsize(os.path.join(out, f"{mode}.mp4")) > 0,
              f"vis_correspondence --mode {mode} wrote no video")
        print(f"vis_correspondence --mode {mode}: {VIS_MODE_LENGTH} frames "
              f"in {mode_s:.2f} s; launches {dict(LAUNCHES)}")
        for k in LAUNCHES:
            launches[k] += LAUNCHES[k]

    import cv2
    video = os.path.join(d, "clip.mp4")
    writer = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"mp4v"), 30,
                             (256, 256))
    clip = smooth_images(VIDEO_FRAMES, torch.Generator().manual_seed(22))
    for f in ((clip.numpy() + 1) * 127.5).round().clip(0, 255).astype(
            np.uint8).transpose(0, 2, 3, 1):
        writer.write(np.ascontiguousarray(f[..., ::-1]))
    writer.release()
    t0 = time.perf_counter()
    n = process_video_cli.main(["--video", video, "--out",
                                os.path.join(d, "clip_lmdb")])
    video_s = time.perf_counter() - t0
    clip_set = MultiResolutionDataset(os.path.join(d, "clip_lmdb"), 256)
    check(n == len(clip_set) == VIDEO_FRAMES
          and clip_set[VIDEO_FRAMES - 1].shape == (3, 256, 256),
          f"process_video wrote {n} frames, read back {len(clip_set)}")
    split = process_video_split(video, os.path.join(d, "clip_split"))
    print(f"cli.process_video: {n} frames of 256 px in {video_s:.2f} s, "
          f"{n / video_s:.1f} frames/s, read back; split over the same "
          f"clip: {', '.join(f'{k} {v * 1e3 / n:.2f} ms' for k, v in split.items())}"
          f" a frame, the CLI's rest (imports, set-up) "
          f"{video_s - sum(split.values()):.3f} s; "
          f"{n / (sum(split.values()) - split['LMDB write']):.1f} frames/s"
          f" of the per-frame work alone")
    shutil.rmtree(d)
    print(f"visualize phase: {time.perf_counter() - start:.1f} s; track "
          f"{n_frames / seconds:.1f} frames/s, a stage's idle share "
          f"{idle:.4f}; launches {launches} [{card}]")
    return launches, errs, (n_frames / seconds, idle, n / video_s)


def main():
    start = time.perf_counter()
    dev, card = setup()
    reals_dir = tempfile.mkdtemp()
    reals = real_lmdb(os.path.join(reals_dir, "reals"))
    errs, times, bounds, library = kernels_vs_plain(dev)
    rates, peak_gib, launches, path_err, k1_path = serve(dev, card)
    errs = {k: max(errs[k], path_err[k]) for k in errs}
    train_rate, train_peak, train_launches, check_launches, train_errs, \
        train_times, cats_vis = train(dev, card, reals)
    ar_rate, ar_peak, ar_launches, ar_check_launches, ar_errs, \
        splat_times, k2_ar = ar(dev, card)
    eval_launches, eval_errs = evaluate(dev, card)
    cluster_launches, cluster_errs, cars_rows, cluster_rates = cluster(
        dev, card, reals)
    vis_launches, vis_errs, vis_rates = visualize(dev, card, reals)
    shutil.rmtree(reals_dir)
    cars_rate, cars_peak, cls_rate, cls_peak, cls_ar_rate, cars_vis = \
        cluster_rates
    bf16_launches, bf16_errs, bf16_rates = precision(
        dev, card, (train_rate, train_peak, cars_rate, cars_peak,
                    rates[128][0]))
    check_launches = {k: check_launches[k] + ar_check_launches[k]
                      for k in LAUNCHES}
    for k, v in (list(train_errs.items()) + list(ar_errs.items())
                 + list(eval_errs.items()) + list(cluster_errs.items())
                 + list(vis_errs.items()) + list(bf16_errs.items())):
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
    print(f"cars step batch {CARS_BATCH}: {cars_rate:.2f} imgs/s, peak "
          f"memory of a step {cars_peak:.2f} GiB; classifier trainer batch "
          f"{CLS_BATCH}: {cls_rate:.2f} imgs/s, peak {cls_peak:.2f} GiB; AR "
          f"with the classifier at batch {AR_BATCH}: {cls_ar_rate:.1f} "
          f"frames/s [{card}]")
    print(f"vis calls: cats {cats_vis[0]:.2f} s, peak {cats_vis[1]:.2f} GiB; "
          f"cars {cars_vis[0]:.2f} s, peak {cars_vis[1]:.2f} GiB; "
          f"vis_correspondence track {vis_rates[0]:.1f} frames/s, a "
          f"stage's idle share {vis_rates[1]:.4f}; process_video "
          f"{vis_rates[2]:.1f} frames/s [{card}]")
    print(f"bfloat16: cats step batch {TRAIN_BATCH} {bf16_rates[0]:.1f} "
          f"imgs/s, peak {bf16_rates[1]:.2f} GiB (float32 {train_rate:.1f}, "
          f"{train_peak:.2f}); cars step batch {CARS_BATCH} "
          f"{bf16_rates[2]:.2f} imgs/s, peak {bf16_rates[3]:.2f} GiB "
          f"(float32 {cars_rate:.2f}, {cars_peak:.2f}); congeal batch 128 "
          f"{bf16_rates[4]:.1f} imgs/s (float32 {rates[128][0]:.1f}) "
          f"[{card}]")
    for name, row in cars_rows.items():
        print(f"{name} at the cars step's shapes, per launch: kernel "
              f"{row[0]:.4f} ms, plain {row[1]:.4f} ms, bound {row[2]:.4f} "
              f"ms ({row[3]}), F.grid_sample on the volume {row[4]:.4f} ms "
              f"[{card}]")
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
    # "launches" counts the main path only: serve, cli.train (with its
    # visuals), the AR apps, the eval apps, the cluster phase's cars run
    # (with its visuals), classifier CLI and AR apps, the visualize
    # phase's vis_correspondence CLI runs, and the precision phase's
    # bfloat16 cli.train runs and congeal forwards, each run with every
    # count zeroed just before it.
    # The backward kernels of the antialias=False form and of an image that
    # needs a gradient run only in the side checks, which count under
    # "check_launches" with the K6 launches of composed_propagate_object's
    # check.
    launches = {k: launches[k] + train_launches[k] + ar_launches[k]
                + eval_launches[k] + cluster_launches[k] + vis_launches[k]
                + bf16_launches[k] for k in LAUNCHES}
    for k in MAIN_PATH_KERNELS:
        check(launches[k] > 0, f"{k} was never launched on the main path")
    for k in set(LAUNCHES) - set(MAIN_PATH_KERNELS):
        check(launches[k] == 0 and check_launches[k] > 0,
              f"{k}: {launches[k]} launches on the main path, "
              f"{check_launches[k]} in its check; expected 0 and more")
    for k, (ms, _, bound_ms, *_) in list(measured.items()) + [
            (f"{k} at the cars step's shapes", v)
            for k, v in cars_rows.items()]:
        check(ms >= bound_ms, f"{k} took {ms:.4f} ms, under its bound of "
              f"{bound_ms:.4f} ms: a timing fault")
    print(f"torch.profiler: {WINDOWS['taken']} windows, "
          f"{WINDOWS['retaken']} of them taken again for a missed kernel")
    print(f"the smoke took {time.perf_counter() - start:.1f} s")
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
