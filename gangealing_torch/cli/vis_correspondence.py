"""Correspondence-visualization CLI on one device (port of
gangealing_tpu/cli/vis_correspondence.py; reference
applications/vis_correspondence.py:440-492).

    python -m gangealing_torch.cli.vis_correspondence --ckpt cat.pt \
        --real_data_path data/cats --label_path label.png --objects \
        --vis_in_stages --stage_flip

The default mode, "track", runs the reference's flagship pipeline:
smoothly animate identity -> congealing warp, track a dense congealed-space
label through the animation both ways, and write smoothly_congeal.mp4,
smoothly_propagate.mp4 and smooth_correspondence.mp4 into ``--out``;
"congeal", "propagate" and "average" write one video each. The flags are
the JAX package's and ``--device``, default ``cuda``: the run raises when
no card is visible. ``--num_devices`` above 1 comes with the multi-GPU
slice.
"""

import os

import numpy as np

from gangealing_torch.cli.args import (
    add_device, base_eval_argparse, refuse_later_slices)


def vis_correspondence_argparse():
    parser = base_eval_argparse()
    parser.add_argument("--label_path", type=str, default=None)
    parser.add_argument("--out", type=str, default="visuals")
    parser.add_argument("--length", "--num_frames", dest="length",
                        default=60, type=int,
                        help="frames per warp-interpolation stage")
    parser.add_argument("--fps", default=60, type=int)
    parser.add_argument("--sigma", default=1.2, type=float)
    parser.add_argument("--opacity", default=0.7, type=float)
    parser.add_argument("--resolution", default=256, type=int,
                        help="resolution of the dense label / flow field")
    parser.add_argument("--output_resolution", default=None, type=int)
    parser.add_argument("--splat_batch", default=100, type=int,
                        help="chunk size for the splatting op")
    parser.add_argument("--vis_in_stages", action="store_true")
    parser.add_argument("--stage_flip", action="store_true",
                        help="animate the mirror flip before the first warp")
    parser.add_argument("--flip_length", default=40, type=int)
    parser.add_argument("--objects", action="store_true",
                        help="load RGB values from the label")
    parser.add_argument("--cluster", default=None, type=int)
    parser.add_argument("--dset_indices", type=int, nargs="+",
                        default=list(range(4)))
    parser.add_argument("--mode", default="track",
                        choices=["track", "congeal", "propagate", "average"])
    parser.add_argument("--flow_scores", default=None, type=str,
                        help="path to cached flow_scores.pt for filtering")
    parser.add_argument("--fraction_retained", default=1.0, type=float,
                        help="fraction of the dataset retained by "
                             "flow-score filtering")
    return add_device(parser)


def main(argv=None):
    """Render the video(s) of ``--mode``; returns the frames (for "track",
    the congealing and the propagation frames)."""
    parser = vis_correspondence_argparse()
    args = parser.parse_args(argv)
    refuse_later_slices(parser, args)

    from gangealing_torch.apps import vis_correspondence as vc
    from gangealing_torch.apps.common import load_stn
    from gangealing_torch.apps.flow_scores import filter_dataset
    from gangealing_torch.data.dataset import MultiResolutionDataset

    model, _ = load_stn(args.ckpt, supersize=args.real_size,
                        override=args.override, device=args.device)
    dset = MultiResolutionDataset(args.real_data_path,
                                  resolution=args.real_size)
    if args.flow_scores is not None:
        dset = filter_dataset(dset, args.flow_scores, args.fraction_retained)
    idx = [i for i in args.dset_indices if i < len(dset)]
    imgs = np.stack([dset[i] for i in idx])
    os.makedirs(args.out, exist_ok=True)
    if args.mode == "track":
        frames = vc.smoothly_congeal_and_propagate(
            model, imgs, label_path=args.label_path, length=args.length,
            iters=args.iters, padding_mode=args.padding_mode,
            output_resolution=args.output_resolution or args.real_size,
            resolution=args.resolution, vis_in_stages=args.vis_in_stages,
            sigma=args.sigma, opacity=args.opacity,
            splat_batch=args.splat_batch,
            no_flip_inference=args.no_flip_inference, objects=args.objects,
            out_dir=args.out, fps=args.fps, cluster=args.cluster,
            stage_flip=args.stage_flip, flip_length=args.flip_length)
        print(f"Wrote videos to {args.out}/")
        return frames
    out = f"{args.out}/{args.mode}.mp4"
    kw = dict(iters=args.iters, padding_mode=args.padding_mode, out_path=out,
              fps=args.fps)
    if args.mode == "congeal":
        frames = vc.smooth_congeal_video(
            model, imgs, args.length,
            no_flip_inference=args.no_flip_inference, **kw)
    elif args.mode == "propagate":
        frames = vc.smooth_propagation_video(
            model, imgs, args.label_path, args.length, sigma=args.sigma, **kw)
    else:
        frames = vc.average_image_video(model, imgs, args.length, **kw)
    print(f"Wrote {out}")
    return frames


if __name__ == "__main__":
    main()
