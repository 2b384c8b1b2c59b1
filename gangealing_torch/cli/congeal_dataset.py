"""Dataset congealing CLI on one card or over ranks (port of
gangealing_tpu/cli/congeal_dataset.py; reference
applications/congeal_dataset.py).

    python -m gangealing_torch.cli.congeal_dataset --ckpt cat.pt \
        --real_data_path data/cats --out data/cats_aligned

The flags are the JAX package's and ``--device``, default ``cuda``: the
run raises when no card is visible. Under ``torchrun`` each rank aligns
its stride of the dataset on ``cuda:LOCAL_RANK`` and rank 0 writes the
LMDB; ``--num_devices``, when given, must equal the world size.
``--num_heads`` other than 1 is refused, as the JAX CLI refuses it.
"""

from gangealing_torch.cli.args import (
    add_device, base_eval_argparse, refuse_later_slices)


def congeal_dataset_argparse():
    parser = base_eval_argparse()
    parser.add_argument("--out", type=str, required=True)
    parser.add_argument("--output_resolution", type=int, default=256)
    parser.add_argument("--flow_scores", default=None, type=str)
    parser.add_argument("--fraction_retained", default=1.0, type=float)
    parser.add_argument("--min_effective_resolution", type=int, default=192)
    return add_device(parser)


def main(argv=None):
    """Align and filter the dataset; returns the retained indices."""
    parser = congeal_dataset_argparse()
    args = parser.parse_args(argv)
    refuse_later_slices(parser, args, unclustered="congealing")

    from gangealing_torch.apps.common import load_stn
    from gangealing_torch.apps.congeal_dataset import align_and_filter_dataset
    from gangealing_torch.parallel.mesh import init_from_env
    args.device = init_from_env(device=args.device)

    model, _ = load_stn(args.ckpt, supersize=args.real_size,
                        override=args.override, device=args.device)
    used = align_and_filter_dataset(
        model, args.real_data_path, args.out, real_size=args.real_size,
        flow_size=args.flow_size, output_resolution=args.output_resolution,
        iters=args.iters, padding_mode=args.padding_mode, batch=args.batch,
        min_effective_resolution=args.min_effective_resolution,
        flow_scores_path=args.flow_scores,
        fraction_retained=args.fraction_retained,
        no_flip_inference=args.no_flip_inference, device=args.device)
    print(f"Saved {len(used)} aligned images to {args.out}")
    return used


if __name__ == "__main__":
    main()
