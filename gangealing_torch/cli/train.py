"""Training CLI on one card or over ranks (port of
gangealing_tpu/cli/train.py).

    python -m gangealing_torch.cli.train --exp-name cats --ckpt cat.pt \
        --load_G_only --padding_mode border --batch 40 --vis_every 5000 \
        --real_data_path data/lsun_cats [...]

    python -m torch.distributed.run --standalone --nproc_per_node 8 \
        -m gangealing_torch.cli.train --batch 5 [...]

The flags are the JAX package's (``base_training_argparse``, the port's
copy in cli/args.py) plus ``--device``, default ``cuda``: the run raises
when no card is visible, and ``--device cpu`` runs it on the CPU. Under
``torchrun`` each rank drives the card ``cuda:LOCAL_RANK`` (NCCL; gloo on
the CPU) and ``--batch`` is the batch of one rank: the global batch is
``--batch`` times the world size, as the JAX CLI multiplies it by the
device count. The ranks average their gradients before each Adam step and
only rank 0 writes files. ``--num_heads K`` and
``--flips`` train a clustering model (scripts/training/lsun_cars.sh); its
cold start picks the K centroids by K-Means++, or takes the first K
latents of the PCA pool with ``--debug``. The training visuals are drawn
every ``--vis_every`` iterations, the congealed reals from the LMDB at
``--real_data_path`` (``--n_mean`` of them averaged, 200 with
``--debug``); ``--profile_dir`` traces steps (``--profile_start``,
``--profile_stop``] with ``torch.profiler``. ``--compute_dtype bfloat16``
runs both generator passes' synthesis and the perceptual trunk in
bfloat16, as the JAX CLI does; the STN, the warps and the optimisers stay
float32. ``--scan_k k`` runs the iterations in blocks of k steps, as the
JAX CLI does; 0, the default, picks 8 when ``--batch`` (one rank's) is
under 16 and 1 otherwise, the JAX CLI's rule. A block runs its k steps
eagerly and reads their scalars from the card once; checkpoints,
visuals and the profiler window land on block boundaries.
"""

import os

import numpy as np
import torch

from gangealing_torch.cli.args import base_training_argparse
from gangealing_torch.data.dataset import DataLoader, MultiResolutionDataset
from gangealing_torch.models.latent_learner import (
    LatentLearner, LatentLearnerConfig)
from gangealing_torch.models.layers import dtype_of
from gangealing_torch.models.lpips import (
    LPIPS, import_torchvision_vgg, make_perceptual_loss)
from gangealing_torch.models.stn import ComposedSTN, ComposedSTNConfig
from gangealing_torch.models.stylegan2 import Generator, GeneratorConfig
from gangealing_torch.parallel.mesh import (
    broadcast_modules, host_barrier, init_from_env, is_primary, world_size)
from gangealing_torch.train.checkpoint import (
    latest_checkpoint, load_checkpoint, module_state, parse_start_iter, resume)
from gangealing_torch.train.loop import cold_start_ll, train_gangealing
from gangealing_torch.train.state import TrainConfig, TrainState
from gangealing_torch.utils.download import find_model


def check_supported(parser, args):
    if args.profile_dir and args.profile_stop <= args.profile_start:
        parser.error(f"--profile_stop ({args.profile_stop}) must be > "
                     f"--profile_start ({args.profile_start})")
    if args.transform == ["similarity"] and args.tv_weight != 0:
        parser.error("TV loss is not supported for similarity-only STNs")


def build_configs(args):
    """The run's configurations; its batch is the global one, ``--batch``
    times the world size."""
    g_cfg = GeneratorConfig(size=args.gen_size, style_dim=args.dim_latent,
                            n_mlp=args.n_mlp,
                            channel_multiplier=args.gen_channel_multiplier,
                            num_fp16_res=args.num_fp16_res)
    t_cfg = ComposedSTNConfig(
        transforms=tuple(args.transform), flow_size=args.flow_size,
        supersize=args.real_size,
        channel_multiplier=args.stn_channel_multiplier,
        num_heads=args.num_heads)
    ll_cfg = LatentLearnerConfig(n_comps=args.ndirs, inject_index=args.inject,
                                 n_latent=g_cfg.n_latent,
                                 num_heads=args.num_heads,
                                 style_dim=args.dim_latent)
    return TrainConfig(
        g=g_cfg, t=t_cfg, ll=ll_cfg, batch=args.batch * world_size(),
        stn_lr=args.stn_lr,
        ll_lr=args.ll_lr, tv_weight=args.tv_weight,
        flow_identity_weight=args.flow_identity_weight,
        freeze_ll=args.freeze_ll, flips=args.flips,
        sample_from_full_res=args.sample_from_full_res,
        padding_mode=args.padding_mode, loss_fn=args.loss_fn,
        anneal_psi=args.anneal_psi, anneal_fn=args.anneal_fn,
        period=args.period, decay=args.decay, tm=args.tm, iter=args.iter,
        compute_dtype=args.compute_dtype)


def load_perceptual(args, device, rng):
    """The VGG16 trunk (and, for lpips, the calibration layers) from
    ``--perceptual_weights``, or random from ``rng``; the loss runs the
    trunk in ``--compute_dtype``."""
    model = LPIPS(use_lins=args.loss_fn == "lpips", device=device,
                  generator=rng)
    if args.perceptual_weights is not None:
        sd = torch.load(args.perceptual_weights, map_location="cpu",
                        weights_only=False)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
        missing, unexpected = model.load_state_dict(
            import_torchvision_vgg(sd), strict=False)
        missing = [k for k in missing if k.startswith("net.")]
        if unexpected or missing:
            raise ValueError(f"{args.perceptual_weights}: unexpected "
                             f"perceptual weights {unexpected}, VGG weights "
                             f"missing {missing}")
    else:
        print("WARNING: no --perceptual_weights given; using a random VGG "
              "(fine for smoke tests, not for real training)")
    model.eval().requires_grad_(False)
    loss = make_perceptual_loss(args.loss_fn, dtype_of(args.compute_dtype))
    return model, lambda x, y: loss(model, x, y)


def real_images(args):
    """The visuals' real images (gangealing_tpu/cli/train.py:154-165): a
    loader over the LMDB at ``--real_data_path`` in batches of
    ``--vis_batch_size``, and ``--n_sample`` images of it, the first or,
    with ``--random_reals``, seeded random ones. (None, None) without a
    path."""
    if args.real_data_path is None:
        return None, None
    dset = MultiResolutionDataset(args.real_data_path,
                                  resolution=args.real_size)
    loader = DataLoader(dset, batch_size=args.vis_batch_size, shuffle=False,
                        drop_last=False)
    idx = (np.random.RandomState(args.seed).randint(
        0, len(dset), args.n_sample) if args.random_reals
        else np.arange(min(args.n_sample, len(dset))))
    return loader, np.stack([dset[int(i)] for i in idx])


def training_argparse():
    """The JAX package's training flags plus ``--device``."""
    parser = base_training_argparse()
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on (default cuda; "
                             "raises when no card is visible)")
    return parser


def main(argv=None):
    """Train as the flags say. Returns (state, generator, perceptual model,
    perceptual_fn) after the last iteration."""
    parser = training_argparse()
    args = parser.parse_args(argv)
    check_supported(parser, args)
    args.n_mean = 200 if args.debug else args.n_mean
    args.vis_batch_size //= args.num_heads
    device = init_from_env(device=args.device)
    results_path = os.path.join(args.results, args.exp_name)
    os.makedirs(results_path, exist_ok=True)
    if args.auto_resume:
        host_barrier("auto_resume")  # every rank reads the same checkpoint
        latest = latest_checkpoint(results_path)
        if latest is not None:
            print(f"--auto_resume: picking up from {latest}")
            args.ckpt = latest
            args.load_G_only = False

    cfg = build_configs(args)
    # the JAX CLI's rule: --scan_k 0 picks 8 steps a block when one rank's
    # batch is under 16 (the reference's per-GPU batch is 5), else 1
    scan_k = args.scan_k if args.scan_k > 0 else (8 if args.batch < 16 else 1)
    if scan_k > 1:
        print(f"scan_k={scan_k}: blocks of {scan_k} optimizer steps, run "
              "eagerly one after another, with one host read of a block's "
              "scalars")
    rngs = [torch.Generator().manual_seed(args.seed * 8 + k) for k in range(3)]
    t = ComposedSTN(cfg.t, device=device, generator=rngs[0])
    ll = LatentLearner(cfg.ll, device=device, generator=rngs[1])
    perceptual, perceptual_fn = load_perceptual(args, device, rngs[2])

    print(f"Loading model from {args.ckpt}")
    ckpt_path, _ = find_model(args.ckpt)
    ckpt = load_checkpoint(ckpt_path)
    generator = Generator(cfg.g, device=device)
    generator.load_state_dict(module_state(ckpt["g_ema"]), strict=True)
    generator.eval().requires_grad_(False)

    state = TrainState(cfg, t, ll)
    start_iter = 0
    if not args.load_G_only and "t" in ckpt:
        print("Resuming STN/ll weights and Adam state from checkpoint")
        resume(state, ckpt)
        start_iter = parse_start_iter(ckpt_path)
    else:
        print("Only G_EMA loaded; running the PCA/kmeans++ cold start")
        cold_start_ll(ll, generator,
                      torch.Generator(device).manual_seed(args.seed * 8 + 3),
                      debug=args.debug, perceptual_fn=perceptual_fn)
    # every rank ran the cold start; rank 0's result holds for all
    broadcast_modules(t, ll, state.t_ema)
    real_loader, sample_reals = real_images(args) if is_primary() \
        else (None, None)
    train_gangealing(state, generator, perceptual_fn, results_path,
                     start_iter=start_iter, seed=args.seed,
                     log_every=args.log_every, ckpt_every=args.ckpt_every,
                     args=args, real_loader=real_loader,
                     sample_reals=sample_reals, n_sample=args.n_sample,
                     n_mean=args.n_mean, vis_batch_size=args.vis_batch_size,
                     vis_every=args.vis_every, profile_dir=args.profile_dir,
                     profile_start=args.profile_start,
                     profile_stop=args.profile_stop, scan_k=scan_k)
    return state, generator, perceptual, perceptual_fn


if __name__ == "__main__":
    main()
