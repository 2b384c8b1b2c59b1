"""Flow-score CLI on one card or over ranks (port of
gangealing_tpu/cli/flow_scores.py; reference applications/flow_scores.py).

    python -m gangealing_torch.cli.flow_scores --ckpt cat.pt \
        --real_data_path data/cats

The flags are the JAX package's ``base_eval_argparse`` and ``--device``,
default ``cuda``: the run raises when no card is visible. Under
``torchrun`` each rank scores its stride of the dataset on
``cuda:LOCAL_RANK`` and rank 0 writes the cache; ``--num_devices``, when
given, must equal the world size. ``--num_heads`` other than 1 is refused,
as the JAX CLI refuses it.
"""

from gangealing_torch.cli.args import (
    add_device, base_eval_argparse, refuse_later_slices)


def flow_scores_argparse():
    return add_device(base_eval_argparse())


def main(argv=None):
    """Score the dataset and cache flow_scores.pt; returns the scores."""
    parser = flow_scores_argparse()
    args = parser.parse_args(argv)
    refuse_later_slices(parser, args, unclustered="flow_scores")
    from gangealing_torch.parallel.mesh import init_from_env
    args.device = init_from_env(device=args.device)
    from gangealing_torch.apps.common import load_stn
    from gangealing_torch.apps.flow_scores import compute_flow_scores

    model, _ = load_stn(args.ckpt, supersize=args.real_size,
                        override=args.override, device=args.device)
    scores = compute_flow_scores(
        model, args.real_data_path, real_size=args.real_size,
        batch=args.batch, iters=args.iters, padding_mode=args.padding_mode,
        no_flip_inference=args.no_flip_inference, save=True,
        device=args.device)
    print(f"num_scores = {scores.shape[0]}")
    print(f"Flow scores saved at {args.real_data_path}/flow_scores.pt")
    return scores


if __name__ == "__main__":
    main()
