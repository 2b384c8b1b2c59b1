"""PCK-Transfer CLI on one device (port of gangealing_tpu/cli/pck.py;
reference applications/pck.py).

    python -m gangealing_torch.cli.pck --ckpt cat.pt \
        --real_data_path data/spair_cats --transfer_both_ways

The flags are the JAX package's and ``--device``, default ``cuda``: the
run raises when no card is visible. ``--num_devices`` above 1 comes with
the multi-GPU slice. As in the JAX CLI, ``--num_heads`` is not read: the
checkpoint's own arguments give the STN.
"""

import numpy as np

from gangealing_torch.cli.args import (
    add_device, base_eval_argparse, refuse_later_slices)


def pck_argparse():
    parser = base_eval_argparse()
    parser.add_argument("--alphas", default=[0.1, 0.05, 0.01], type=float,
                        nargs="+")
    parser.add_argument("--num_pck_pairs", default=None, type=int)
    parser.add_argument("--transfer_both_ways", action="store_true")
    parser.add_argument("--num_bootstrap", default=0, type=int)
    parser.add_argument("--out", default="visuals", type=str)
    parser.add_argument("--vis_transfer", action="store_true",
                        help="save a PNG visualizing keypoint transfers "
                             "(reference applications/pck.py:77-100)")
    return add_device(parser)


def main(argv=None):
    """Evaluate PCK-Transfer as the flags say; returns the (A,) PCK and,
    with ``--num_bootstrap``, the (A,) standard deviations (else None)."""
    parser = pck_argparse()
    args = parser.parse_args(argv)
    refuse_later_slices(parser, args)

    from gangealing_torch.apps.common import load_stn
    from gangealing_torch.apps.pck import pck_transfer, vis_transfer
    from gangealing_torch.data.dataset import DataLoader, PCKDataset

    model, _ = load_stn(args.ckpt, supersize=args.real_size,
                        override=args.override, device=args.device)
    dset = PCKDataset(args.real_data_path, resolution=args.real_size,
                      seed=args.seed)
    num_pairs = args.num_pck_pairs or len(dset)
    loader = DataLoader(dset, batch_size=args.batch, shuffle=False,
                        drop_last=False)
    kw = dict(iters=args.iters, padding_mode=args.padding_mode,
              match_flows=not args.no_flip_inference,
              permutation=dset.mirror_permutation)
    if args.vis_transfer:
        vis_transfer(model, loader, out_dir=args.out, **kw)
    kw.update(alphas=args.alphas, num_pairs=num_pairs,
              transfer_both_ways=args.transfer_both_ways)
    pck = pck_transfer(model, loader, progress=True, **kw)
    print(" | ".join(f"PCK-Transfer@{a}: {p * 100:.2f}%"
                     for a, p in zip(args.alphas, pck)))

    std = None
    if args.num_bootstrap > 0:
        rng = np.random.RandomState(args.seed)
        pcks = []
        for _ in range(args.num_bootstrap):
            if dset.fixed_pairs is not None:
                dset.randomize_fixed_pairs(int(rng.randint(0, 2 ** 31)))
            else:
                dset.randomize_pairs(int(rng.randint(0, 2 ** 31)))
            pcks.append(pck_transfer(
                model, DataLoader(dset, batch_size=args.batch,
                                  shuffle=False, drop_last=False), **kw))
        std = np.stack(pcks).std(axis=0, ddof=1)
        print("-----Bootstrapping Results (standard deviations)-----")
        print(" | ".join(f"PCK-Transfer@{a}: {s * 100:.2f}%"
                         for a, s in zip(args.alphas, std)))
    return pck, std


if __name__ == "__main__":
    main()
