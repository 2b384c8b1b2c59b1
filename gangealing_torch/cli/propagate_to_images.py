"""Static-image propagation CLI on one card or over ranks (port of
gangealing_tpu/cli/propagate_to_images.py; reference
applications/propagate_to_images.py, flags :108-138).

    python -m gangealing_torch.cli.propagate_to_images --ckpt cat.pt \
        --real_data_path data/cats --label_path label.png --objects

The flags are the JAX package's and ``--device``, default ``cuda``: the
run raises when no card is visible. A clustering model runs with the
cluster classifier its checkpoint holds (``--cluster``). Under
``torchrun`` each rank propagates to its stride of the images on
``cuda:LOCAL_RANK`` and rank 0 writes the visuals; ``--num_devices``,
when given, must equal the world size.
"""

import os

import numpy as np

from gangealing_torch.cli.args import (
    add_device, base_eval_argparse, refuse_later_slices)


def propagate_to_images_argparse():
    parser = base_eval_argparse()
    parser.add_argument("--label_path", type=str, default=None)
    parser.add_argument("--out", type=str, default="visuals")
    parser.add_argument("-s", "--sigma", default=1.3, type=float)
    parser.add_argument("-o", "--opacity", default=0.75, type=float)
    parser.add_argument("--blend_alg", default="alpha", type=str)
    parser.add_argument("--objects", action="store_true",
                        help="take propagated colors from the label's RGB "
                             "(object propagation) instead of a colorscale")
    parser.add_argument("--cluster", default=None, type=int)
    parser.add_argument("--n_mean", type=int, default=-1,
                        help="number of images averaged for the average "
                             "congealed image; -1 creates no average visual "
                             "(reference propagate_to_images.py n_mean "
                             "semantics; unlike the reference, the average "
                             "is taken over the selected/propagated images, "
                             "not a separate dataset pass)")
    parser.add_argument("--average_path", type=str, default=None,
                        help="path to a precomputed average aligned image; "
                             "the label is splatted onto it and saved as "
                             "average_annotated.png (reference "
                             "make_visuals, propagate_to_images.py:74-78)")
    parser.add_argument("--output_resolution", type=int, default=None,
                        help="resolution of the congealed output images")
    parser.add_argument("--resolution", default=256, type=int,
                        help="resolution of the label / flow field")
    parser.add_argument("--dset_indices", type=int, nargs="+", default=None,
                        help="specific dataset indices to propagate to")
    parser.add_argument("--flow_scores", default=None, type=str,
                        help="path to cached flow_scores.pt for filtering")
    parser.add_argument("--fraction_retained", default=1.0, type=float,
                        help="fraction of the dataset retained by flow-score "
                             "filtering")
    parser.add_argument("--save_individual_images", action="store_true",
                        help="save every image separately instead of only "
                             "grids")
    parser.add_argument("--n_images", default=16, type=int)
    return add_device(parser)


def main(argv=None):
    """Congeal the selected dataset images and propagate the label onto
    them; returns the app's result dict."""
    parser = propagate_to_images_argparse()
    args = parser.parse_args(argv)
    refuse_later_slices(parser, args)

    from gangealing_torch.apps.common import load_stn
    from gangealing_torch.apps.flow_scores import filter_dataset
    from gangealing_torch.apps.propagate_to_images import (
        annotate_average, propagate_to_images)
    from gangealing_torch.data.dataset import MultiResolutionDataset
    from gangealing_torch.parallel.mesh import init_from_env, is_primary
    args.device = init_from_env(device=args.device)

    model, _, classifier = load_stn(
        args.ckpt, supersize=args.real_size, override=args.override,
        device=args.device, load_classifier=True)
    dset = MultiResolutionDataset(args.real_data_path,
                                  resolution=args.real_size)
    if args.flow_scores is not None:
        dset = filter_dataset(dset, args.flow_scores, args.fraction_retained)
    if args.dset_indices is not None:
        indices = list(args.dset_indices)
    else:
        indices = list(range(min(args.n_images, len(dset))))
    imgs = np.stack([dset[i] for i in indices])
    result = propagate_to_images(
        model, imgs, label_path=args.label_path, sigma=args.sigma,
        opacity=args.opacity, blend_alg=args.blend_alg, iters=args.iters,
        padding_mode=args.padding_mode, batch=args.batch,
        classifier=classifier, cluster=args.cluster, objects=args.objects,
        no_flip_inference=args.no_flip_inference, out_dir=args.out,
        resolution=args.resolution,
        output_resolution=args.output_resolution,
        average_n=0 if args.n_mean < 0 else args.n_mean)
    if args.average_path is not None and args.label_path is None:
        print("warning: --average_path is only used together with "
              "--label_path (the label is splatted onto the average); "
              "ignoring it (reference make_visuals semantics)")
    if not is_primary():
        return result
    if args.average_path is not None and args.label_path is not None:
        result["average_annotated"] = annotate_average(
            args.average_path, args.label_path, args.real_size,
            args.resolution, output_resolution=args.output_resolution,
            sigma=args.sigma, opacity=args.opacity, objects=args.objects,
            out_dir=args.out)
    if args.save_individual_images:
        from gangealing_torch.utils.vis import save_image
        for name in ("congealed", "propagated"):
            if name not in result:
                continue
            for j, img in zip(indices, result[name]):
                save_image(img[None],
                           os.path.join(args.out, name, f"{j:05d}.png"),
                           normalize=True, range=(-1, 1))
    print(f"Wrote visuals to {args.out}")
    return result


if __name__ == "__main__":
    main()
