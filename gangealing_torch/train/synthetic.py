"""The synthetic full-system GANgealing demo: a fixed differentiable
"generator" with structure that can be aligned, so that joint latent
learner and ComposedSTN training can be run and checked end to end without
a pre-trained StyleGAN2.

Port of gangealing_tpu/train/synthetic.py:

  * ``make_template``: a structured, orientation-asymmetric RGB template.
  * ``synthetic_generator``: maps a W-space latent to the template warped
    by a similarity transform plus a smooth elastic flow read linearly off
    the latent. On the card it samples through ``grid_sample_auto``: K2
    forward and, where the latent needs a gradient, K4 for d/dgrid, so the
    target's gradient reaches the latent learner as it does through a
    real G.
  * ``make_synthetic_pair_sampler``: the ``pair_sampler`` of
    ``train_step``: unaligned = G_syn(z), target = G_syn(ll(z, psi)).
  * ``run_synthetic_congealing``: the demo loop through the real
    ``train_step`` (two Adams and the EMA), its loss curve and the
    congealed variance before and after.

z of iteration i comes from ``train/loop.py::iteration_rng(seed, i)``, so
the loss curve is not JAX's number for number. As in the reference (and
unlike the JAX demo, which hands the whole ll dict to Adam), the latent
learner's ``directions`` and ``lat_mean`` are buffers: only the
coefficients learn.
"""

from dataclasses import dataclass

import numpy as np
import torch

from gangealing_torch.apps.common import resolve_device
from gangealing_torch.models.latent_learner import (
    LatentLearner, LatentLearnerConfig)
from gangealing_torch.models.stn import ComposedSTN, ComposedSTNConfig
from gangealing_torch.ops.grid_sample import affine_grid, grid_sample_auto
from gangealing_torch.ops.resample import interpolate_bilinear
from gangealing_torch.train.annealing import psi_at_iter
from gangealing_torch.train.loop import iteration_rng
from gangealing_torch.train.state import TrainConfig, TrainState, train_step


# latent layout: [rot, log_scale, tx, ty, elastic(2*4*4=32), mode...]
N_POSE = 4
ELASTIC_GRID = 4
N_ELASTIC = 2 * ELASTIC_GRID * ELASTIC_GRID
STYLE_DIM = N_POSE + N_ELASTIC + 1  # +1 mode channel for K=2 demos


def make_template(size: int, mode: int = 0, device=None) -> torch.Tensor:
    """A structured, orientation-asymmetric (3, size, size) float32
    template in [-1, 1], built in numpy. ``mode`` selects visually distinct
    variants for cluster demos."""
    y, x = np.meshgrid(np.linspace(-1, 1, size), np.linspace(-1, 1, size),
                       indexing="ij")
    r = np.sqrt(x ** 2 + y ** 2)
    img = np.zeros((3, size, size), np.float32)
    if mode == 0:
        img[0] = np.cos(6 * r) * (r < 0.8)
        img[1] = ((x + y) > 0) * (r < 0.6) * 0.8
        img[2] = np.exp(-((x - 0.3) ** 2 + (y + 0.2) ** 2) / 0.02)
        img[0] += np.exp(-((x + 0.4) ** 2 + y ** 2) / 0.01)  # off-center dot
    else:
        img[2] = np.cos(4 * (x + 1.3 * y)) * (np.abs(x) < 0.7)
        img[0] = (np.abs(x - 0.2) + np.abs(y) < 0.5) * 0.9
        img[1] = np.exp(-((x + 0.3) ** 2 + (y - 0.35) ** 2) / 0.02)
    return torch.from_numpy(np.clip(img, -1, 1)).to(device)


def synthetic_warp_grid(w, size: int, pose_scale=0.35, elastic_scale=0.08):
    """The (N, S, S, 2) sampling grid G_syn uses: maps output pixel
    coordinates to template coordinates (grid_sample semantics)."""
    N = w.shape[0]
    rot = w[:, 0] * pose_scale
    scale = torch.exp(w[:, 1] * pose_scale * 0.6)
    tx = w[:, 2] * pose_scale * 0.6
    ty = w[:, 3] * pose_scale * 0.6
    cos, sin = torch.cos(rot), torch.sin(rot)
    theta = torch.stack([
        torch.stack([scale * cos, -scale * sin, tx], -1),
        torch.stack([scale * sin, scale * cos, ty], -1)], 1)  # (N, 2, 3)
    grid = affine_grid(theta, (N, 3, size, size))  # (N, S, S, 2)
    el = w[:, N_POSE:N_POSE + N_ELASTIC].reshape(
        N * 2, 1, ELASTIC_GRID, ELASTIC_GRID)
    el = interpolate_bilinear(el, size, size).reshape(N, 2, size, size)
    return grid + elastic_scale * el.permute(0, 2, 3, 1)


def synthetic_generator(templates, w, size: int, pose_scale=0.35,
                        elastic_scale=0.08):
    """Differentiable G_syn: (N, STYLE_DIM) W latents -> (N, 3, S, S).

    Pose and a smooth elastic flow are linear readouts of the latent; with
    two templates the image is a sigmoid blend of the two driven by the
    mode channel, so cluster identity is itself a differentiable function
    of w. Each template is tiled N times into a contiguous batch, which K2
    reads as it lies."""
    N = w.shape[0]
    grid = synthetic_warp_grid(w, size, pose_scale, elastic_scale)
    outs = [grid_sample_auto(t[None].expand(N, -1, -1, -1).contiguous(),
                             grid, padding_mode="border")
            for t in templates]
    if len(templates) == 1:
        return outs[0]
    gate = torch.sigmoid(w[:, N_POSE + N_ELASTIC] * 4.0).reshape(N, 1, 1, 1)
    return (1 - gate) * outs[0] + gate * outs[1]


def make_synthetic_pair_sampler(templates, ll_cfg: LatentLearnerConfig,
                                size: int, freeze_ll=False, **render_kwargs):
    """``pair_sampler(ll, z, psi)`` for ``train_step``: unaligned =
    G_syn(z), target = G_syn(ll(z, psi)), K targets a sample in the latent
    learner's k-fastest layout (the cartesian STN's). ``ll_cfg`` is kept
    for the JAX signature; the module carries its own."""
    del ll_cfg

    def sampler(ll, z, psi):
        unaligned = synthetic_generator(templates, z, size, **render_kwargs)
        with torch.set_grad_enabled(torch.is_grad_enabled() and not freeze_ll):
            wplus = ll(z, psi)
            target = synthetic_generator(templates, wplus[:, 0, :], size,
                                         **render_kwargs)
        return unaligned, target
    return sampler


def l2_perceptual_fn(x, y):
    """Per-sample mean squared distance in the perceptual_fn interface:
    (N, 1, 1, 1), like LPIPS's per-sample output."""
    return ((x - y) ** 2).mean(dim=(1, 2, 3)).reshape(-1, 1, 1, 1)


@dataclass
class SyntheticDemoResult:
    losses: np.ndarray            # (iters,) perceptual loss curve
    var_before: float             # mean per-pixel variance, congealed @init
    var_after: float              # ... after training (the live STN)
    state: TrainState
    t_cfg: ComposedSTNConfig
    ll_cfg: LatentLearnerConfig


def synthetic_configs(size, num_heads, channel_multiplier=0.25):
    """The demo's STN and latent learner configurations."""
    t_cfg = ComposedSTNConfig(transforms=("similarity", "flow"),
                              flow_size=size, supersize=size,
                              channel_multiplier=channel_multiplier,
                              flow_downsample=4, max_channels=64,
                              num_heads=num_heads)
    ll_cfg = LatentLearnerConfig(n_comps=N_POSE + 1, inject_index=1,
                                 n_latent=2, num_heads=num_heads,
                                 style_dim=STYLE_DIM)
    return t_cfg, ll_cfg


def synthetic_latent_learner(ll_cfg, device=None, generator=None):
    """The demo's latent learner: the pose dims and the mode dim as its
    directions, a zero mean, and with two heads each head's coefficients
    in a distinct mode of the data (a kmeans++-style init)."""
    ll = LatentLearner(ll_cfg, device=device, generator=generator)
    dirs = np.zeros((N_POSE + 1, STYLE_DIM), np.float32)
    dirs[:N_POSE, :N_POSE] = np.eye(N_POSE)
    dirs[N_POSE, N_POSE + N_ELASTIC] = 1.0  # mode channel
    ll.assign_pca(torch.from_numpy(dirs), torch.zeros(1, STYLE_DIM))
    if ll_cfg.num_heads > 1:
        coef = torch.zeros(ll_cfg.num_heads, N_POSE + 1)
        coef[0, N_POSE] = -1.5
        coef[1, N_POSE] = 1.5
        ll.assign_coefficients(coef)
    return ll


@torch.no_grad()
def congealed_variance(t, imgs, num_heads):
    """The mean per-pixel variance over the images of their congealed
    forms. With K heads each image takes the head whose output is nearest
    that head's congealed mean (a proxy for the training assignment)."""
    out = t(imgs, padding_mode="border")[0]
    if num_heads > 1:
        n = imgs.shape[0]
        out = out.reshape(n, num_heads, *out.shape[1:])
        means = out.mean(dim=0, keepdim=True)
        pick = ((out - means) ** 2).mean(dim=(2, 3, 4)).argmin(dim=1)
        out = out[torch.arange(n, device=out.device), pick]
    return float(out.var(dim=0, unbiased=False).mean())


def eval_images(templates, n, size, seed, device):
    """The demo's ``n`` eval images: G_syn of latents drawn from iteration
    0's generator, which the training loop never draws."""
    z = torch.randn(n, STYLE_DIM, device=device,
                    generator=iteration_rng(seed, 0, device))
    with torch.no_grad():
        return synthetic_generator(templates, z, size)


def post_anneal_descent(losses, anneal_end):
    """tests/test_full_system.py's measure: the mean loss over the 8
    iterations after psi reaches 0 and over the last 8. During annealing
    the loss rises by design, so descent is only measured after it."""
    return (float(np.mean(losses[anneal_end:anneal_end + 8])),
            float(np.mean(losses[-8:])))


def run_synthetic_congealing(iters=150, size=64, batch=16, num_heads=1,
                             seed=0, stn_lr=1e-3, ll_lr=5e-3,
                             tv_weight=100.0, flow_identity_weight=1.0,
                             anneal_frac=0.3, channel_multiplier=0.25,
                             eval_n=32, progress=False,
                             device="cuda") -> SyntheticDemoResult:
    """Joint latent learner and ComposedSTN training on the synthetic
    generator through the real ``train_step``. Returns the loss curve and
    the congealed variance before (the EMA at init) and after (the live
    STN: at demo length the EMA still lags its init)."""
    device = resolve_device(device)
    templates = [make_template(size, m, device) for m in range(num_heads)]
    t_cfg, ll_cfg = synthetic_configs(size, num_heads, channel_multiplier)
    t = ComposedSTN(t_cfg, device=device,
                    generator=torch.Generator().manual_seed(seed + 1))
    ll = synthetic_latent_learner(
        ll_cfg, device, torch.Generator().manual_seed(seed + 2))
    cfg = TrainConfig(g=None, t=t_cfg, ll=ll_cfg, batch=batch,
                      stn_lr=stn_lr, ll_lr=ll_lr, tv_weight=tv_weight,
                      flow_identity_weight=flow_identity_weight,
                      anneal_psi=max(1, int(iters * anneal_frac)),
                      padding_mode="border", loss_fn="vgg_ssl")
    sampler = make_synthetic_pair_sampler(templates, ll_cfg, size)
    state = TrainState(cfg, t, ll)

    eval_imgs = eval_images(templates, eval_n, size, seed, device)
    var_before = congealed_variance(state.t_ema, eval_imgs, num_heads)

    losses = []
    for i in range(1, iters + 1):
        psi = psi_at_iter(i, cfg.anneal_psi, cfg.anneal_fn)
        z = torch.randn(batch, STYLE_DIM, device=device,
                        generator=iteration_rng(seed, i, device))
        metrics = train_step(state, None, l2_perceptual_fn, z, psi, stn_lr,
                             ll_lr, pair_sampler=sampler)
        losses.append(metrics["p"])
        if progress and i % 25 == 0:
            print(f"[{i}/{iters}] p={float(losses[-1]):.5f} psi={psi:.3f}",
                  flush=True)
    losses = torch.stack(losses).cpu().numpy()
    var_after = congealed_variance(state.t, eval_imgs, num_heads)
    return SyntheticDemoResult(losses, var_before, var_after, state, t_cfg,
                               ll_cfg)
