"""The GANgealing training loop, on one card or over ranks.

Port of gangealing_tpu/train/loop.py (reference train.py:31-266): per
iteration the psi and the learning rates from train/annealing.py, z and
the generator's noise from a generator seeded by the iteration, one train
step, scalars into ``scalars.jsonl``, checkpoints every ``ckpt_every``
iterations and at every zero of the learning rate, the training visuals
(train/visuals.py) at the start, every ``vis_every`` iterations, at
iteration 100 and at every zero of the learning rate, and an optional
``torch.profiler`` window. The cold start fits the latent learner's PCA on
a pool of W latents kept on the device, and with K heads its coefficients
on K-Means++ centroids.

With ``scan_k`` k > 1 the iterations run in blocks of k
(``state.train_block``, the JAX loop's ``lax.scan`` blocks), with the JAX
loop's cadence: each iteration's inputs are drawn as a single step draws
them, the block's metrics are read from the device once, and a
checkpoint, a visual or the profiler window's ends land on the block's
boundaries.

Over ranks (parallel/mesh.py) every rank draws the global batch's z and
both generator passes' noise from the iteration's generator and keeps its
rows (``rank_rows``), so the ranks together step on what one process would
draw; only the primary rank writes opt.txt, the scalars, the checkpoints,
the visuals and the profiler trace.
"""

import json
import os
import time

import torch

from gangealing_torch.models.latent_learner import fit_pca, pca_encode
from gangealing_torch.parallel.mesh import is_primary, shard_global_batch
from gangealing_torch.train.checkpoint import save_checkpoint
from gangealing_torch.train.clustering import kmeans_plusplus
from gangealing_torch.train.state import TrainState, train_block
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


def draw_step_inputs(generator, rng, batch, heads):
    """The global batch's z and the noise of both generator passes, drawn
    from ``rng`` in the order the step's generator passes draw them: z,
    then the noise of the pass at ``batch`` images, then that of the pass
    at ``batch * heads``. Returns (z, (noise, noise))."""
    dev = generator.input.input.device
    z = torch.randn(batch, generator.cfg.style_dim, generator=rng,
                    device=dev)
    return z, (generator.make_noise(batch, rng),
               generator.make_noise(batch * heads, rng))


def rank_rows(z, noise, heads):
    """This rank's rows of ``draw_step_inputs``: the block of z's rows
    [r*N/W, (r+1)*N/W) (shard_global_batch), the same rows of the first
    pass's noise, and of the second pass's the rows of those samples: the
    latent learner lays its N*K targets out sample by sample, head k of
    sample n at row n*K + k."""
    n_u, n_a = noise

    def by_sample(x):
        x = x.reshape(-1, heads, *x.shape[1:])
        return shard_global_batch(x).flatten(0, 1)
    return shard_global_batch(z), ([shard_global_batch(x) for x in n_u],
                                   [by_sample(x) for x in n_a])


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
                     profile_start=0, profile_stop=0, scan_k=1):
    """Run iterations start_iter+1 .. cfg.iter. ``perceptual_fn(x, y)`` ->
    (N, 1, 1, 1). Returns the state.

    ``scan_k``: run the iterations in blocks of this many steps while a
    whole block fits, then single steps. A block does what its k single
    steps do; its scalars are logged for each iteration as a single step
    logs them, from one host read of the block's metrics, and a
    checkpoint or a visual due at any iteration of a block is written at
    its last iteration (the visual with that iteration's psi).

    ``real_loader`` (batches of real images, numpy) and ``sample_reals``
    feed the visuals' congealed reals; ``vis_every`` 0 draws no visuals.
    ``profile_dir``: trace iterations (profile_start, profile_stop] of
    this run, counted from ``start_iter`` (a resumed run traces its own
    new steps), into a Chrome trace there; the trace starts at the first
    block that overlaps the window and stops at the end of the block that
    reaches its end, and a window reaching past the last iteration ends
    with it."""
    cfg = state.cfg
    check_profile_window(profile_dir, profile_start, profile_stop,
                         start_iter, cfg.iter)
    device = next(state.t.parameters()).device
    primary = is_primary()
    profile_dir = profile_dir if primary else None
    if primary:
        with open(os.path.join(results_path, "opt.txt"), "w") as f:
            json.dump({k: str(v) for k, v in cfg.__dict__.items()}, f,
                      indent=2)
    zero_lr = set(lr_cycle_iters(cfg.anneal_psi, cfg.period, cfg.iter, cfg.tm))
    early_vis = {100} | zero_lr
    K = cfg.t.num_heads
    fixed = vis_rng(seed, -1, device)
    sample_z = torch.randn(max(1, n_sample // K), cfg.g.style_dim,
                           generator=fixed, device=device)
    big_sample_z = torch.randn(n_mean, cfg.g.style_dim, generator=fixed,
                               device=device) if K > 1 else None
    writer = GANgealingWriter(results_path) if primary else None

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

    scan_k = max(1, int(scan_k))
    prof = trace_first = None
    t0 = time.time()
    n_total = cfg.iter - start_iter
    idx = 0  # steps of this run before the block
    try:
        if vis_every > 0 and primary:
            vis(start_iter, 1.0 if cfg.anneal_psi > 0 else 0.0)
        while idx < n_total:
            blk = scan_k if idx + scan_k <= n_total else 1
            iters = range(start_iter + idx + 1, start_iter + idx + blk + 1)
            # start when the block overlaps the window: a window inside one
            # block is captured whole
            if profile_dir and prof is None and idx + blk > profile_start \
                    and idx < profile_stop:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)  # a step boundary
                prof, trace_first = start_trace(), iters[0]
            psis = [psi_at_iter(i, cfg.anneal_psi, cfg.anneal_fn)
                    for i in iters]
            lr_ts, lr_lls = ([lr_used_at_iter(i, lr, cfg.anneal_psi,
                                              cfg.period, cfg.tm, cfg.decay)
                              for i in iters]
                             for lr in (cfg.stn_lr, cfg.ll_lr))
            inputs = [rank_rows(*draw_step_inputs(
                generator, iteration_rng(seed, i, device), cfg.batch, K), K)
                for i in iters]
            metrics = train_block(state, generator, perceptual_fn,
                                  [z for z, _ in inputs],
                                  [noise for _, noise in inputs], psis,
                                  lr_ts, lr_lls)
            if prof is not None and idx + blk >= profile_stop:
                stop_trace(prof, profile_dir)
                prof = None
                print(f"\n[profiler] trace of iterations {trace_first}.."
                      f"{iters[-1]} written to {profile_dir}", flush=True)
            logged = [j for j, i in enumerate(iters)
                      if i % log_every == 0 or i in zero_lr]
            if primary and logged:
                # one host read of the block's metrics
                p, tv, f = torch.stack([metrics[k] for k in ("p", "tv", "f")
                                        ]).tolist()
                for j in logged:
                    i = iters[j]
                    writer.add_scalar("Loss/Reconstruction", p[j], i)
                    writer.add_scalar("Loss/TotalVariation", tv[j], i)
                    writer.add_scalar("Loss/FlowIdentity", f[j], i)
                    writer.add_scalar("Progress/psi", psis[j], i)
                    writer.add_scalar("Progress/STN_LearningRate", lr_ts[j],
                                      i)
                    writer.add_scalar("Progress/LL_LearningRate", lr_lls[j],
                                      i)
                j = logged[-1]
                rate = (iters[j] - start_iter) * cfg.batch / max(
                    time.time() - t0, 1e-9)
                print(f"\r[{iters[j]}/{cfg.iter}] p={p[j]:.4f} "
                      f"tv={tv[j]:.6f} psi={psis[j]:.4f} {rate:.1f} imgs/s",
                      end="", flush=True)
            # a checkpoint or a visual due inside a block is written at its
            # end, where the state is
            if primary and ckpt_every > 0 and any(
                    i % ckpt_every == 0 or i in zero_lr for i in iters):
                save_checkpoint(os.path.join(results_path, "checkpoints",
                                             f"{str(iters[-1]).zfill(7)}.pt"),
                                state, generator, iters[-1], args=args)
            if primary and vis_every > 0 and any(
                    i % vis_every == 0 or i in early_vis for i in iters):
                vis(iters[-1], psis[-1])
            idx += blk
        if prof is not None:  # the window reached past the last iteration
            stop_trace(prof, profile_dir)
            prof = None
            print(f"\n[profiler] trace of iterations {trace_first}.."
                  f"{cfg.iter} written to {profile_dir} (window extended "
                  "past the last iteration; captured what ran)", flush=True)
        if primary:
            print()
    finally:
        if writer is not None:
            writer.close()
    return state
