"""The GANgealing training driver on one card.

Port of gangealing_tpu/train/loop.py (reference train.py:31-266) without the
mesh and the k-step scan: per iteration the psi and the learning rates from
train/annealing.py, z and the generator's noise from a generator seeded by
the iteration, one train step, scalars into ``scalars.jsonl``, checkpoints
every ``ckpt_every`` iterations and at every zero of the learning rate,
the training visuals (train/visuals.py) at the start, every ``vis_every``
iterations, at iteration 100 and at every zero of the learning rate, and
an optional ``torch.profiler`` window. The cold start fits the latent
learner's PCA on a pool of W latents kept on the device, and with K heads
its coefficients on K-Means++ centroids.
"""

import json
import os
import time

import torch

from gangealing_torch.models.latent_learner import fit_pca, pca_encode
from gangealing_torch.train.checkpoint import save_checkpoint
from gangealing_torch.train.clustering import kmeans_plusplus
from gangealing_torch.train.state import TrainState, train_step
from gangealing_torch.train.annealing import (
    lr_cycle_iters, lr_used_at_iter, psi_at_iter)
from gangealing_torch.train.visuals import (
    GANgealingWriter, create_training_cluster_visuals,
    create_training_visuals)
from gangealing_torch.utils.profiling import start_trace, stop_trace

PCA_CHUNK = 10000  # W latents made per generator call of the cold start
KMEANS_LATENTS = 50000  # the K-Means++ pool of the cold start (train.py)
# The visuals' generators draw from seeds of their own, apart from the
# iterations' (iteration_rng) for any seed under 2**30.
VIS_STREAM = 1 << 62


def iteration_rng(seed, i, device):
    """The generator of iteration ``i``: z and the generator's noise of an
    iteration depend on the seed and ``i`` only, so a resumed run draws
    what an uninterrupted one would."""
    return torch.Generator(device).manual_seed((seed << 32) + i)


def vis_rng(seed, i, device):
    """The generator of the visuals at iteration ``i``; ``i = -1`` is the
    one that draws their fixed latents."""
    return torch.Generator(device).manual_seed(VIS_STREAM + (seed << 32)
                                               + i + 1)


@torch.no_grad()
def cold_start_ll(ll, generator, rng, debug=False, perceptual_fn=None):
    """Fit the latent learner's directions and mean by PCA of a pool of W
    latents, 1M of them (1000 with ``debug``), made and kept on the
    generator's device (train.py:228-243). With K > 1 heads, the
    coefficients are the PCA codes of K centroids: K-Means++ over
    KMEANS_LATENTS latents under ``perceptual_fn``, or the pool's first K
    latents with ``debug``."""
    n_pca = 1000 if debug else 1000000
    ws = torch.cat([generator.batch_latent(min(PCA_CHUNK, n_pca - i), rng)
                    for i in range(0, n_pca, PCA_CHUNK)])
    components, mean = fit_pca(ws, ll.cfg.n_comps)
    ll.assign_pca(components, mean)
    K = ll.cfg.num_heads
    if K > 1:
        if debug:
            centroids = ws[:K]
        else:
            centroids = kmeans_plusplus(
                generator, perceptual_fn, K, KMEANS_LATENTS, rng,
                inject_index=ll.cfg.inject_index)
        ll.assign_coefficients(pca_encode(centroids, components, mean))


def _log(writer, i, metrics, psi, lr_t, lr_ll):
    m = {k: float(metrics[k]) for k in ("p", "tv", "f")}
    writer.add_scalar("Loss/Reconstruction", m["p"], i)
    writer.add_scalar("Loss/TotalVariation", m["tv"], i)
    writer.add_scalar("Loss/FlowIdentity", m["f"], i)
    writer.add_scalar("Progress/psi", psi, i)
    writer.add_scalar("Progress/STN_LearningRate", lr_t, i)
    writer.add_scalar("Progress/LL_LearningRate", lr_ll, i)
    return m


def check_profile_window(profile_dir, profile_start, profile_stop,
                         start_iter, iters):
    """The JAX loop's checks of the profiler window (loop.py:118-125)."""
    if not profile_dir:
        return
    if profile_stop <= profile_start:
        raise ValueError(
            f"profile_stop ({profile_stop}) must be > profile_start "
            f"({profile_start}) when profile_dir is set")
    if profile_start >= iters - start_iter:
        raise ValueError(
            f"profile window ({profile_start}, {profile_stop}] starts "
            f"past the {iters - start_iter} steps this run will "
            f"execute (start_iter={start_iter}, iter={iters}); "
            "no trace would be captured")


def train_gangealing(state: TrainState, generator, perceptual_fn,
                     results_path, start_iter=0, seed=0, log_every=25,
                     ckpt_every=50000, args=None, real_loader=None,
                     sample_reals=None, n_sample=64, n_mean=8000,
                     vis_batch_size=250, vis_every=5000, profile_dir=None,
                     profile_start=0, profile_stop=0):
    """Run iterations start_iter+1 .. cfg.iter. ``perceptual_fn(x, y)`` ->
    (N, 1, 1, 1). Returns the state.

    ``real_loader`` (batches of real images, numpy) and ``sample_reals``
    feed the visuals' congealed reals; ``vis_every`` 0 draws no visuals.
    ``profile_dir``: trace iterations (profile_start, profile_stop] of
    this run, counted from ``start_iter`` (a resumed run traces its own
    new steps), into a Chrome trace there; a window reaching past the
    last iteration ends with it."""
    cfg = state.cfg
    check_profile_window(profile_dir, profile_start, profile_stop,
                         start_iter, cfg.iter)
    device = next(state.t.parameters()).device
    with open(os.path.join(results_path, "opt.txt"), "w") as f:
        json.dump({k: str(v) for k, v in cfg.__dict__.items()}, f, indent=2)
    zero_lr = set(lr_cycle_iters(cfg.anneal_psi, cfg.period, cfg.iter, cfg.tm))
    early_vis = {100} | zero_lr
    K = cfg.t.num_heads
    fixed = vis_rng(seed, -1, device)
    sample_z = torch.randn(max(1, n_sample // K), cfg.g.style_dim,
                           generator=fixed, device=device)
    big_sample_z = torch.randn(n_mean, cfg.g.style_dim, generator=fixed,
                               device=device) if K > 1 else None
    writer = GANgealingWriter(results_path)

    def vis(i, psi):
        kw = dict(padding_mode=cfg.padding_mode,
                  rng=vis_rng(seed, i, device))
        if K > 1:
            create_training_cluster_visuals(
                generator, state.t_ema, state.ll, perceptual_fn, real_loader,
                sample_z, big_sample_z, psi, n_mean, n_sample, K, cfg.flips,
                vis_batch_size, i, writer, **kw)
        else:
            create_training_visuals(
                generator, state.t_ema, state.ll, real_loader, sample_reals,
                sample_z, psi, n_mean, n_sample, i, writer, **kw)

    prof = trace_first = None
    t0 = time.time()
    try:
        if vis_every > 0:
            vis(start_iter, 1.0 if cfg.anneal_psi > 0 else 0.0)
        for i in range(start_iter + 1, cfg.iter + 1):
            idx = i - start_iter - 1  # steps of this run before this one
            if profile_dir and prof is None and profile_start <= idx \
                    < profile_stop:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)  # a step boundary
                prof, trace_first = start_trace(), i
            psi = psi_at_iter(i, cfg.anneal_psi, cfg.anneal_fn)
            lr_t, lr_ll = (lr_used_at_iter(i, lr, cfg.anneal_psi, cfg.period,
                                           cfg.tm, cfg.decay)
                           for lr in (cfg.stn_lr, cfg.ll_lr))
            rng = iteration_rng(seed, i, device)
            z = torch.randn(cfg.batch, cfg.g.style_dim, generator=rng,
                            device=device)
            metrics = train_step(state, generator, perceptual_fn, z, psi,
                                 lr_t, lr_ll, rng=rng)
            if prof is not None and idx + 1 >= profile_stop:
                stop_trace(prof, profile_dir)
                prof = None
                print(f"\n[profiler] trace of iterations {trace_first}.."
                      f"{i} written to {profile_dir}", flush=True)
            if i % log_every == 0 or i in zero_lr:
                m = _log(writer, i, metrics, psi, lr_t, lr_ll)
                rate = (i - start_iter) * cfg.batch / max(time.time() - t0,
                                                          1e-9)
                print(f"\r[{i}/{cfg.iter}] p={m['p']:.4f} tv={m['tv']:.6f} "
                      f"psi={psi:.4f} {rate:.1f} imgs/s", end="", flush=True)
            if ckpt_every > 0 and (i % ckpt_every == 0 or i in zero_lr):
                save_checkpoint(os.path.join(results_path, "checkpoints",
                                             f"{str(i).zfill(7)}.pt"),
                                state, generator, i, args=args)
            if vis_every > 0 and (i % vis_every == 0 or i in early_vis):
                vis(i, psi)
        if prof is not None:  # the window reached past the last iteration
            stop_trace(prof, profile_dir)
            prof = None
            print(f"\n[profiler] trace of iterations {trace_first}.."
                  f"{cfg.iter} written to {profile_dir} (window extended "
                  "past the last iteration; captured what ran)", flush=True)
        print()
    finally:
        writer.close()
    return state
