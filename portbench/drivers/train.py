"""Traffic of kind "train": the GANgealing training loop's body, one trainer.

Each unit is one iteration as ``gangealing_torch/train/loop.py`` runs it
with ``scan_k`` 1: the iteration's z and both generator passes' noise, psi
and the two learning rates from the schedule at the iteration's number,
one ``train_block`` call of one step, and a host read of the loss terms
every ``log_every`` iterations. The benchmark draws z and the noise itself
from the seed and the iteration, so that the reference gets the same.

Set-up builds one training state from the seeded weights and drives it
through the first ``checked_steps`` iterations through the same body;
that same state then runs the window. Once the window has closed, the
state is put back to the seeded weights in place (Adam's moments and
step count zeroed, the EMA reloaded) and the same iterations run again
through the same body, in whatever mode the window left the program. The
reference follows those iterations once, at the precision the
configurations state, from the same weights and inputs; each number
compared is the larger of the two passes': the first step's loss and its
perceptual term, the first gradient (read back from Adam's first moment)
and the change of the parameters and of the EMA over the checked steps.
"""

import math
import statistics
import time

import torch

from gangealing_torch import _build
from gangealing_torch.models.latent_learner import (
    LatentLearner, LatentLearnerConfig)
from gangealing_torch.models.layers import dtype_of
from gangealing_torch.models.lpips import LPIPS, make_perceptual_loss
from gangealing_torch.models.stn import ComposedSTN, ComposedSTNConfig
from gangealing_torch.models.stylegan2 import Generator, GeneratorConfig
from gangealing_torch.train.state import TrainConfig, TrainState, train_block

from portbench import bounds
from portbench.reference import mipmap as ref_mipmap
from portbench.reference.annealing import lr_used_at_iter, psi_at_iter
from portbench.reference.train import (
    ReferenceTrainer, build_modules, model_configs, stated_precision)
from portbench.reference.weights import seeded_state

BETA1 = 0.9  # the port's Adam (train/state.py::make_adam)
STREAMS = {"g": 1, "t": 2, "ll": 3, "lpips": 4}
# a leaf whose first reference gradient is under this share of the median
# leaf's moves under Adam by round-off alone: left out of the changes
STILL_LEAF = 1e-3


def program_config(cfg, batch, compute_dtype):
    """The port's TrainConfig of a configuration file's dict. A
    ``compute_dtype`` other than float32 switches on every lower-precision
    path the port has: G's synthesis, the perceptual trunk and the STN's
    encoders."""
    g, t, ll, tr = (cfg["generator"], cfg["stn"], cfg["latent_learner"],
                    cfg["train"])
    g_cfg = GeneratorConfig(size=g["size"], style_dim=g["style_dim"],
                            n_mlp=g["n_mlp"],
                            channel_multiplier=g["channel_multiplier"],
                            max_channels=g.get("max_channels", 512))
    t_cfg = ComposedSTNConfig(
        transforms=tuple(t["transforms"]), flow_size=t["flow_size"],
        supersize=t["supersize"], channel_multiplier=t["channel_multiplier"],
        num_heads=t["num_heads"], flow_downsample=t["flow_downsample"],
        antialias=t["antialias"], max_channels=t.get("max_channels", 512),
        compute_dtype=compute_dtype)
    ll_cfg = LatentLearnerConfig(n_comps=ll["ndirs"], inject_index=ll["inject"],
                                 n_latent=g_cfg.n_latent,
                                 num_heads=t["num_heads"],
                                 style_dim=g["style_dim"])
    keys = ("stn_lr", "ll_lr", "tv_weight", "flow_identity_weight", "flips",
            "sample_from_full_res", "padding_mode", "loss_fn", "anneal_psi",
            "anneal_fn", "period", "decay", "tm", "iter")
    return TrainConfig(g=g_cfg, t=t_cfg, ll=ll_cfg, batch=batch,
                       compute_dtype=compute_dtype,
                       **{k: tr[k] for k in keys})


def seeded_states(cfg, seed, device):
    """The weights of every module of the configuration, drawn from the
    seed on the device: {"g", "t", "ll", "lpips": state_dict}."""
    meta = build_modules(cfg, "meta")
    return {name: seeded_state(m, seed, STREAMS[name], device)
            for name, m in meta.items()}


class Inputs:
    """z and the noise of both generator passes of iteration ``i``, drawn
    from (seed, i) in one call on the device, and the schedule's psi and
    learning rates at ``i``."""

    def __init__(self, cfg, batch, seed, device):
        self.g_cfg, _, _ = model_configs(cfg)
        self.tr = cfg["train"]
        self.batch, self.seed, self.device = batch, int(seed), device
        self.heads = cfg["stn"]["num_heads"]

    def __call__(self, i):
        shapes = [(self.batch, self.g_cfg.style_dim)]
        shapes += self.g_cfg.noise_shapes(self.batch)
        shapes += self.g_cfg.noise_shapes(self.batch * self.heads)
        gen = torch.Generator(self.device).manual_seed(
            (self.seed << 24) + i)
        flat = torch.randn(sum(math.prod(s) for s in shapes), generator=gen,
                           device=self.device)
        parts, at = [], 0
        for s in shapes:
            parts.append(flat[at:at + math.prod(s)].view(s))
            at += math.prod(s)
        n = len(self.g_cfg.noise_shapes(1))
        z, noise = parts[0], (parts[1:1 + n], parts[1 + n:])
        tr = self.tr
        psi = psi_at_iter(i, tr["anneal_psi"], tr["anneal_fn"])
        lr_t, lr_ll = (lr_used_at_iter(i, tr[k], tr["anneal_psi"],
                                       tr["period"], tr["tm"], tr["decay"])
                       for k in ("stn_lr", "ll_lr"))
        return z, noise, psi, lr_t, lr_ll


def learned(state):
    """{name: tensor} of the port's learned parameters and its EMA, under
    the reference trainer's names."""
    out = {f"t.{k}": v for k, v in state.t.named_parameters()}
    out.update({f"ll.{k}": v for k, v in state.ll.named_parameters()})
    out.update({f"t_ema.{k}": v for k, v in state.t_ema.named_parameters()})
    return out


def first_gradients(state):
    """The first step's gradients as Adam got them: its first moment after
    one step is (1 - beta1) times the gradient."""
    out = {}
    for prefix, module, optim in (("t", state.t, state.t_optim),
                                  ("ll", state.ll, state.ll_optim)):
        for k, p in module.named_parameters():
            st = optim.state.get(p)
            out[f"{prefix}.{k}"] = (st["exp_avg"] / (1.0 - BETA1) if st
                                    else torch.zeros_like(p))
    return out


def leaf_gaps(ours, ref, keep):
    """{leaf: gap} over the leaves in ``keep``: the gap between the norm of
    a leaf of ``ours`` and of ``ref``, over the larger of that reference
    leaf's norm and the median reference leaf's; and the median gap."""
    norms = {k: float(ref[k].double().norm()) for k in keep}
    median = statistics.median(norms.values())
    gaps = {k: abs(float(ours[k].double().norm()) - norms[k])
            / max(norms[k], median, 1e-30) for k in keep}
    return gaps, statistics.median(gaps.values())


def leaf_diffs(ours, ref, keep):
    """{leaf: the norm of the difference of ``ours`` and ``ref``, over the
    larger of the reference leaf's norm and the median leaf's}."""
    norms = {k: float(ref[k].double().norm()) for k in keep}
    median = statistics.median(norms.values())
    return {k: float((ours[k].double() - ref[k].double()).norm())
            / max(norms[k], median, 1e-30) for k in keep}


def worst_leaf_gap(ours, ref, keep):
    """The largest of ``leaf_gaps`` and its leaf's name."""
    gaps, _ = leaf_gaps(ours, ref, keep)
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


# the numbers a limit may hold
COMPARED = ("loss_gap", "p_gap", "grad_gap", "change_gap",
            "median_change_gap")


def compare(cfg, ours, ref, names, readings=False):
    """The numbers ``names`` of one pass, and with ``readings`` every
    candidate and the statistics a calibration reads beside them; and the
    notes of the pass. ``ours`` and ``ref`` are (loss terms of each
    checked step, first gradients, learned tensors before, after)."""
    terms_o, grads_o, before_o, after_o = ours
    terms_r, grads_r, before_r, after_r = ref
    tr = cfg["train"]
    names = set(COMPARED if readings else names)

    def total(t):
        return t[0] + tr["tv_weight"] * t[1] + \
            tr["flow_identity_weight"] * t[2]
    loss_gaps = [abs(total(a) - total(b)) / abs(total(b))
                 for a, b in zip(terms_o, terms_r)]
    numbers = {"loss_gap": loss_gaps[0],
               "p_gap": abs(terms_o[0][0] - terms_r[0][0])
               / abs(terms_r[0][0])}
    notes = {}
    norms = {k: float(v.double().norm()) for k, v in grads_r.items()}
    median = statistics.median(norms.values())
    moving = [k for k, n in norms.items() if n >= STILL_LEAF * median]
    if "grad_gap" in names:
        numbers["grad_gap"], notes["worst gradient leaf"] = worst_leaf_gap(
            grads_o, grads_r, moving)
    moved = moving + [f"t_ema.{k[2:]}" for k in moving if k.startswith("t.")]
    change = {k: after_o[k] - before_o[k] for k in after_o}
    ref_change = {k: after_r[k] - before_r[k] for k in after_r}
    if names & {"change_gap", "median_change_gap"}:
        gaps, numbers["median_change_gap"] = leaf_gaps(change, ref_change,
                                                       moved)
        worst = max(gaps, key=gaps.get)
        numbers["change_gap"] = gaps[worst]
        notes["worst change leaf"] = worst
        notes["leaves left out as still"] = sorted(set(norms) - set(moving))
    numbers = {k: v for k, v in numbers.items() if k in names}
    if readings:
        diffs = leaf_diffs(grads_o, grads_r, moving)
        numbers.update({
            "later_loss_gap": max(loss_gaps[1:], default=0.0),
            "grad_diff": max(diffs.values()),
            "median_grad_diff": statistics.median(diffs.values()),
            "change_diff": max(leaf_diffs(change, ref_change,
                                          moved).values())})
    return numbers, notes


class TrainCell:
    """One training state of the port, its loop body, and its check."""

    def __init__(self, cfg, traffic, seed, device, parts,
                 compute_dtype="float32"):
        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.batch = traffic["batch"]
        self.unit_images = self.batch
        self.log_every = traffic["log_every"]
        t0 = time.perf_counter()
        if device.type == "cuda":
            _build.load_kernels()
        parts["kernel library"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.states = seeded_states(cfg, seed, device)
        self._sync()
        parts["seeded weights"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        pcfg = program_config(cfg, self.batch, compute_dtype)
        self.generator = Generator(pcfg.g, device=device)
        self.generator.load_state_dict(self.states["g"], strict=True)
        self.generator.eval().requires_grad_(False)
        lpips = LPIPS(use_lins=pcfg.loss_fn == "lpips", device=device)
        lpips.load_state_dict(self.states["lpips"], strict=True)
        lpips.eval().requires_grad_(False)
        loss = make_perceptual_loss(pcfg.loss_fn, dtype_of(compute_dtype))
        self.perceptual_fn = lambda x, y: loss(lpips, x, y)
        t = ComposedSTN(pcfg.t, device=device)
        t.load_state_dict(self.states["t"], strict=True)
        ll = LatentLearner(pcfg.ll, device=device)
        ll.load_state_dict(self.states["ll"], strict=True)
        self.state = TrainState(pcfg, t, ll)
        self.inputs = Inputs(cfg, self.batch, seed, device)
        self.start = traffic["start_iter"]
        self._sync()
        parts["the port's modules"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.initial = {k: v.detach().clone()
                        for k, v in learned(self.state).items()}
        self.passes = [self.checked_pass()]
        self._sync()
        parts["checked steps (warm-up)"] = time.perf_counter() - t0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run_unit(self):
        """One iteration of the loop body; returns its metrics."""
        self.i += 1
        z, noise, psi, lr_t, lr_ll = self.inputs(self.i)
        metrics = train_block(self.state, self.generator, self.perceptual_fn,
                              [z], [noise], [psi], [lr_t], [lr_ll])
        if self.i % self.log_every == 0:  # the loop's host read
            torch.stack([metrics[k] for k in ("p", "tv", "f")]).tolist()
        return metrics

    def checked_pass(self):
        """The first ``checked_steps`` iterations from the traffic's start
        through the loop body: (the loss terms of each step, the first
        gradients, the learned tensors after)."""
        self.i = self.start
        metrics = []
        for step in range(self.traffic["checked_steps"]):
            metrics.append(self.run_unit())
            if step == 0:
                grads = {k: v.clone() for k, v in
                         first_gradients(self.state).items()}
        after = {k: v.detach().clone()
                 for k, v in learned(self.state).items()}
        terms = [[float(x) for x in
                  torch.stack([m[k][0] for k in ("p", "tv", "f")])]
                 for m in metrics]
        return terms, grads, after

    def reset(self):
        """The training state put back to the seeded weights in place: the
        STN and its EMA, the latent learner, and both Adams' moments and
        step counts."""
        st = self.state
        with torch.no_grad():
            st.t.load_state_dict(self.states["t"], strict=True)
            st.t_ema.load_state_dict(self.states["t"], strict=True)
            st.ll.load_state_dict(self.states["ll"], strict=True)
            for optim in (st.t_optim, st.ll_optim):
                for slots in optim.state.values():
                    for k, v in slots.items():
                        if torch.is_tensor(v):
                            v.zero_()
                        else:
                            slots[k] = 0

    def release(self):
        """Once the window has closed: the checked steps again from the
        seeded state, through the same state and body; then the program's
        state freed before the reference runs."""
        self.reset()
        self.passes.append(self.checked_pass())
        self._sync()
        del self.state, self.generator, self.perceptual_fn
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, names, count=False, readings=False):
        """The reference over the checked steps: the numbers ``names`` (with
        ``readings``, every candidate and statistic) of each pass and the
        larger of the two, and with ``count`` the yardstick's counters of
        one step (model FLOPs, the sampler launches' least times)."""
        *ref, counters = self.reference(count)
        numbers, notes = {}, {}
        for tag, (terms, grads, after) in zip(("set-up", "after window"),
                                              self.passes):
            got, why = compare(self.cfg, (terms, grads, self.initial, after),
                               ref, names, readings)
            for k, v in got.items():
                numbers[k] = max(numbers.get(k, v), v)
                notes[f"{k} ({tag})"] = v
            notes.update({f"{k} ({tag})": v for k, v in why.items()})
        return numbers, notes, counters

    def reference(self, count=False):
        """The reference's readings over the checked steps, as the
        program's: (loss terms of each step, first gradients, learned
        tensors before and after, counters)."""
        ref = ReferenceTrainer(self.cfg, self.states, self.device)
        before = {k: v.detach().clone() for k, v in ref.learned().items()}
        terms, grads, counters = [], None, {}
        with stated_precision():
            for step in range(self.traffic["checked_steps"]):
                args = self.inputs(self.start + 1 + step)
                if step == 0 and count:
                    t_terms, grads, counters = self._counted(ref, args)
                else:
                    t_terms, g = ref.step(*args)
                    grads = g if grads is None else grads
                terms.append(t_terms)
        after = {k: v.detach() for k, v in ref.learned().items()}
        return terms, grads, before, after, counters

    def _counted(self, ref, args):
        """A reference step under the FLOP counter, its warps recorded for
        the sampler launches' bytes (traced runs only: the counter's
        import is left out of the other runs' set-up)."""
        from torch.utils.flop_counter import FlopCounterMode
        flops = FlopCounterMode(display=False)
        ref_mipmap.RECORDER = warps = []
        try:
            with flops:
                terms, grads = ref.step(*args)
        finally:
            ref_mipmap.RECORDER = None
        return terms, grads, {"model_flops_per_unit": flops.get_total_flops(),
                              **sampler_least_s(warps, backward=True)}


def sampler_least_s(warps, backward):
    """The least seconds of each K1 (and, with ``backward``, K3) launch
    over the recorded warps, averaged over the launches: the texels of
    the pyramid the points reach, the points' grid and levels, and the
    outputs, by ``bounds.pyramid_texel_bytes`` and ``sampler_ops``."""
    k1, k3 = [], []
    for shape, grid, levels, pm in warps:
        N, C = shape[0], shape[1]
        points = levels.numel()
        out = C * points * 4  # float32 (N, C, Ho, Wo)
        io = bounds.nbytes(grid, levels) + out
        k1.append(bounds.bound(
            bounds.pyramid_texel_bytes(shape, grid, levels, pm) + io,
            bounds.sampler_ops("mipmap_sample", points, C))[0] / 1e3)
        if backward:
            # reads the grid, levels and dout; writes dgrid and dlevels
            moved = bounds.pyramid_texel_bytes(shape, grid, levels, pm,
                                               dcoords=True) + \
                2 * bounds.nbytes(grid, levels) + out
            k3.append(bounds.bound(moved, bounds.sampler_ops(
                "mipmap_sample_dcoords", points, C))[0] / 1e3)
    out = {"k1_least_s": sum(k1) / len(k1)} if k1 else {}
    if k3:
        out["k3_least_s"] = sum(k3) / len(k3)
    return out


def build(cfg, traffic, seed, device, parts, compute_dtype="float32"):
    return TrainCell(cfg, traffic, seed, device, parts, compute_dtype)
