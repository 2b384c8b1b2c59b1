"""Traffic of kind "congeal": the served ComposedSTN forward, one client.

The model is what ``apps/common.py::load_stn`` builds from a checkpoint
that set-up writes from the seeded weights. The images are smooth 256 px
images drawn on the device from the seed into a pool of distinct batches,
cycled. Each unit is one forward of a batch (``iters`` 1, border padding),
ended by a synchronize as an app that reads each batch back ends it.

The check runs the reference forward on a sample of the pool's batches,
drawn from the seed, and compares the congealed images, grids and flows
that the window's last forward of each produced.
"""

import contextlib
import dataclasses
import os
import random
import time

import torch

from gangealing_torch import _build
from gangealing_torch.apps.common import load_stn

from portbench.drivers.train import sampler_least_s
from portbench.reference import mipmap as ref_mipmap
from portbench.reference.resample import interpolate_bilinear
from portbench.reference.stn import ComposedSTN
from portbench.reference.train import full_float32, model_configs
from portbench.reference.weights import seeded_state

STN_STREAM = 2


def smooth_images(n, size, generator, device):
    """Images without pixel-scale detail: tanh of bilinearly upsampled
    16x16 noise (``chip_smoke.py::smooth_images``)."""
    low = torch.randn(n, 3, 16, 16, generator=generator, device=device)
    return torch.tanh(2 * interpolate_bilinear(low, size, size))


def checkpoint_args(cfg):
    """The hyperparameters ``load_stn`` reads from a checkpoint."""
    t = cfg["stn"]
    return {"transform": list(t["transforms"]), "flow_size": t["flow_size"],
            "real_size": t["supersize"],
            "stn_channel_multiplier": t["channel_multiplier"],
            "num_heads": t["num_heads"],
            "flow_downsample": t["flow_downsample"]}


def load_seeded_stn(cfg, state, device, compute_dtype="float32"):
    """The port's STN as ``apps/common.py::load_stn`` builds it from a
    checkpoint of ``state``, written under TMPDIR and removed after; a
    ``compute_dtype`` other than float32 switches on the port's own
    lower-precision encoders."""
    path = os.path.join(os.environ.get("TMPDIR", "/tmp"),
                        f"portbench_stn_{os.getpid()}.pt")
    torch.save({"t_ema": {k: v.cpu() for k, v in state.items()},
                "args": checkpoint_args(cfg)}, path)
    try:
        model, _ = load_stn(path, supersize=cfg["stn"]["supersize"],
                            device=device)
    finally:
        os.remove(path)
    if compute_dtype != "float32":
        for stn in model.stns:
            stn.cfg = dataclasses.replace(stn.cfg, compute_dtype=compute_dtype)
    return model


class CongealCell:
    def __init__(self, cfg, traffic, seed, device, parts,
                 compute_dtype="float32"):
        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.seed = int(seed)
        self.batch = traffic["batch"]
        self.unit_images = self.batch
        t0 = time.perf_counter()
        if device.type == "cuda":
            _build.load_kernels()
        parts["kernel library"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, t_cfg, _ = model_configs(cfg)
        self.state = seeded_state(ComposedSTN(t_cfg, device="meta"), seed,
                                  STN_STREAM, device)
        gen = torch.Generator(device).manual_seed((self.seed << 8) + 9)
        size = cfg["stn"]["supersize"]
        self.pool = [smooth_images(self.batch, size, gen, device)
                     for _ in range(traffic["pool"])]
        parts["weights and images"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.model = load_seeded_stn(cfg, self.state, device, compute_dtype)
        parts["checkpoint"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.n = 0
        self.last = [None] * len(self.pool)
        for _ in range(traffic["warmup"]):
            self.run_unit()
        parts["warm-up"] = time.perf_counter() - t0

    def run_unit(self):
        slot = self.n % len(self.pool)
        with torch.inference_mode():
            out, grid, flow, _, _ = self.model(self.pool[slot], iters=1,
                                               padding_mode="border")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.last[slot] = (out, grid, flow)
        self.n += 1

    def release(self):
        del self.model
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, names, count=False, readings=False):
        """The reference forward over a sample of the pool: the largest
        errors of the image, grid and flow (all three are compared), the
        notes, and with ``count`` the yardstick's counters of a batch."""
        _, t_cfg, _ = model_configs(self.cfg)
        ref = ComposedSTN(t_cfg, device=self.device)
        ref.load_state_dict(self.state, strict=True)
        ref.eval()
        ran = [s for s, got in enumerate(self.last) if got is not None]
        slots = random.Random(self.seed).sample(
            ran, min(self.traffic["checked_batches"], len(ran)))
        gaps = {"image_err": 0.0, "grid_err": 0.0, "flow_err": 0.0}
        counters = {}
        if count:
            from torch.utils.flop_counter import FlopCounterMode
        for k, slot in enumerate(slots):
            counting = count and k == 0
            warps = []
            flops = (FlopCounterMode(display=False)
                     if counting else contextlib.nullcontext())
            ref_mipmap.RECORDER = warps if counting else None
            try:
                with torch.no_grad(), full_float32(), flops:
                    want = ref(self.pool[slot], iters=1,
                               padding_mode="border")[:3]
            finally:
                ref_mipmap.RECORDER = None
            if counting:
                counters = {"model_flops_per_unit": flops.get_total_flops(),
                            **sampler_least_s(warps, backward=False)}
            for name, got, w in zip(gaps, self.last[slot], want):
                err = (float((got.float() - w).abs().max())
                       if got.shape == w.shape else float("inf"))
                gaps[name] = max(gaps[name], err)
        notes = {"batches checked": slots}
        return gaps, notes, counters


def build(cfg, traffic, seed, device, parts, compute_dtype="float32"):
    return CongealCell(cfg, traffic, seed, device, parts, compute_dtype)
