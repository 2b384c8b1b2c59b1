"""Argparse bases shared by the CLIs.

The port's own copy of gangealing_tpu/cli/args.py (reference
utils/base_argparse.py:4-60 for the training flags,
applications/__init__.py:7-27 for the eval flags). Flag names and defaults
are the JAX package's, so launch scripts carry over unchanged; the port's
CLIs refuse the flags of what they do not run yet, naming the slice that
brings it, and what the JAX CLIs refuse, for the JAX CLIs' reason.
``--num_devices`` names the world size: one rank drives one card, so there
is no local mesh for it to cap.
"""

import argparse
import os


def base_training_argparse():
    p = argparse.ArgumentParser(description="GANgealing Training")
    p.add_argument("--exp-name", type=str, required=True)
    p.add_argument("--ckpt", type=str, required=True,
                   help="StyleGAN2 generator checkpoint (torch .pt) or a "
                        "previous GANgealing checkpoint to resume")
    p.add_argument("--load_G_only", action="store_true")
    p.add_argument("--dim_latent", type=int, default=512)
    p.add_argument("--n_mlp", type=int, default=8)
    p.add_argument("--gen_channel_multiplier", type=int, default=2)
    p.add_argument("--num_fp16_res", type=int, default=0)
    p.add_argument("--results", type=str, default="results")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--real_data_path", type=str, default=None)
    p.add_argument("--real_size", default=256, type=int)
    p.add_argument("--gen_size", default=256, type=int)
    p.add_argument("--iter", type=int, default=800000)
    p.add_argument("--batch", type=int, default=5,
                   help="per-device batch size")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--auto_resume", action="store_true",
                   help="resume from the newest checkpoint in the results "
                        "dir if one exists (preemption-safe relaunch: just "
                        "rerun the same command)")
    # GANgealing hyperparameters:
    p.add_argument("--inject", default=5, type=int)
    p.add_argument("--ndirs", default=1, type=int)
    p.add_argument("--anneal_psi", default=150000, type=int)
    p.add_argument("--anneal_fn", type=str, choices=["cosine", "linear"],
                   default="cosine")
    p.add_argument("--loss_fn", type=str, default="vgg_ssl",
                   choices=["lpips", "vgg_ssl"])
    p.add_argument("--tv_weight", default=1000.0, type=float)
    p.add_argument("--flow_identity_weight", default=1.0, type=float)
    p.add_argument("--freeze_ll", action="store_true")
    p.add_argument("--sample_from_full_res", action="store_true")
    # clustering:
    p.add_argument("--num_heads", default=1, type=int)
    p.add_argument("--flips", action="store_true")
    # model:
    p.add_argument("--transform", default=["similarity", "flow"],
                   choices=["similarity", "flow"], nargs="+", type=str)
    p.add_argument("--padding_mode", default="reflection",
                   choices=["border", "zeros", "reflection"], type=str)
    p.add_argument("--stn_lr", type=float, default=0.001)
    p.add_argument("--ll_lr", type=float, default=0.01)
    p.add_argument("--flow_size", type=int, default=128)
    p.add_argument("--stn_channel_multiplier", type=float, default=0.5)
    # visualization:
    p.add_argument("--vis_every", type=int, default=5000)
    p.add_argument("--ckpt_every", type=int, default=50000)
    p.add_argument("--log_every", default=25, type=int)
    p.add_argument("--n_mean", type=int, default=8000)
    p.add_argument("--n_sample", type=int, default=64)
    p.add_argument("--vis_batch_size", default=250, type=int)
    p.add_argument("--random_reals", action="store_true")
    # observability (no reference equivalent):
    p.add_argument("--profile_dir", type=str, default=None,
                   help="trace training steps (profile_start, "
                        "profile_stop] into this directory")
    p.add_argument("--profile_start", type=int, default=5,
                   help="number of steps to run before the trace starts")
    p.add_argument("--profile_stop", type=int, default=10,
                   help="step count (of this run) after which the trace "
                        "stops; must be > --profile_start")
    # LR schedule:
    p.add_argument("--period", default=37500, type=float)
    p.add_argument("--decay", default=0.9, type=float)
    p.add_argument("--tm", default=2, type=int)
    # step blocks and precision:
    p.add_argument("--scan_k", type=int, default=0,
                   help="optimizer steps a block: the steps run eagerly one "
                        "after another and a block's scalars are read once "
                        "(the same math and schedule as single steps; "
                        "checkpoint and visual points round to block ends). "
                        "0 = auto: 8 when the per-rank batch is < 16, else 1")
    p.add_argument("--perceptual_weights", type=str, default=None,
                   help="optional torch state_dict with VGG16 weights")
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    return p


def base_eval_argparse():
    p = argparse.ArgumentParser(description="GANgealing Evaluation")
    p.add_argument("--ckpt", type=str, required=True)
    p.add_argument("--transform", default=["similarity", "flow"],
                   choices=["similarity", "flow"], nargs="+", type=str)
    p.add_argument("--flow_size", type=int, default=128)
    p.add_argument("--stn_channel_multiplier", type=float, default=0.5)
    p.add_argument("--num_heads", default=1, type=int)
    p.add_argument("--override", action="store_true")
    p.add_argument("--iters", default=1, type=int)
    p.add_argument("--padding_mode", default="border",
                   choices=["border", "zeros", "reflection"], type=str)
    p.add_argument("--no_flip_inference", action="store_true")
    p.add_argument("--real_data_path", type=str, default=None)
    p.add_argument("--real_size", default=256, type=int)
    p.add_argument("--batch", type=int, default=50)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--num_devices", default=None, type=int,
                   help="split eval batches over this many devices "
                        "(default: all; 1 runs on one)")
    return p


def add_device(parser):
    """The port's one flag beyond the JAX package's: the torch device."""
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on (default cuda; raises "
                             "when no card is visible)")
    return parser


def refuse_later_slices(parser, args, unclustered=None):
    """Refuse an eval CLI's flags of what the port does not run: a
    ``--num_devices`` other than the world size (each rank drives one
    card; launch that many ranks with torchrun instead) and, with
    ``unclustered``, the name of an app that takes no clustering model,
    ``--num_heads`` other than 1, as the JAX CLI of that app does
    (gangealing_tpu/cli/flow_scores.py:8, cli/congeal_dataset.py:14)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))  # torchrun's
    if args.num_devices is not None and args.num_devices != world:
        parser.error(
            f"--num_devices {args.num_devices} differs from the world size "
            f"({world}): each rank drives one card, so launch "
            f"{args.num_devices} ranks with torchrun (python -m "
            f"torch.distributed.run --nproc_per_node {args.num_devices} "
            "-m gangealing_torch.cli.<app> ...) instead")
    if unclustered is not None and args.num_heads != 1:
        parser.error(f"clustering not supported for {unclustered}")
