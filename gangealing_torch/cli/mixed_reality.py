"""Mixed-reality video CLI on one device (port of
gangealing_tpu/cli/mixed_reality.py; reference
applications/mixed_reality.py).

    python -m gangealing_torch.cli.mixed_reality --ckpt cat.pt \
        --video_path frames/ --label_path label.png --out visuals

The flags are the JAX package's (``base_eval_argparse`` plus the app's
own) and ``--device``, default ``cuda``: the run raises when no card is
visible. A clustering model runs with the cluster classifier its
checkpoint holds (``--cluster``, ``--average_path``). ``--num_devices``
above 1 comes with the multi-GPU slice.
"""

import os

from gangealing_torch.cli.args import (
    add_device, base_eval_argparse, refuse_later_slices)


def mixed_reality_argparse():
    parser = base_eval_argparse()
    parser.add_argument("--video_path", type=str, required=True,
                        help="mp4 file or directory of frames")
    parser.add_argument("--label_path", type=str, default=None)
    parser.add_argument("--out", type=str, default="visuals")
    parser.add_argument("--sigma", default=1.2, type=float)
    parser.add_argument("--opacity", default=1.0, type=float)
    parser.add_argument("--blend_alg", default="alpha", type=str,
                        choices=["alpha", "laplacian", "laplacian_light"])
    parser.add_argument("--objects", action="store_true")
    parser.add_argument("--save_correspondences", action="store_true")
    parser.add_argument("--resolution", default=None, type=int,
                        help="resolution at which to load the label")
    parser.add_argument("--cluster", default=None, type=int)
    parser.add_argument("--fps", default=30, type=int)
    parser.add_argument("--max_frames", default=None, type=int)
    parser.add_argument("--save_frames", action="store_true",
                        help="stream per-frame PNGs to disk instead of "
                             "holding the whole video in memory")
    parser.add_argument("--average_path", default=None, type=str,
                        help="path to the cluster0 average congealed image "
                             "(clustering models; adds average.mp4)")
    parser.add_argument("--overlay_congealed", action="store_true",
                        help="overlay the input dense label on the "
                             "congealed video")
    return add_device(parser)


def main(argv=None):
    """Run the app as the flags say; returns its result dict."""
    parser = mixed_reality_argparse()
    args = parser.parse_args(argv)
    refuse_later_slices(parser, args)

    from gangealing_torch.apps.common import load_stn
    from gangealing_torch.apps.mixed_reality import run_gangealing_on_video
    from gangealing_torch.data.prepare import (
        list_frame_paths, load_video_frames)

    model, _, classifier = load_stn(
        args.ckpt, supersize=args.real_size, override=args.override,
        device=args.device, load_classifier=True)
    if args.save_frames and os.path.isdir(args.video_path):
        # a lazy path list: frames load one batch at a time
        frames = list_frame_paths(args.video_path)
        if args.max_frames is not None:
            frames = frames[:args.max_frames]
    else:
        frames = load_video_frames(args.video_path,
                                   max_frames=args.max_frames)
    result = run_gangealing_on_video(
        model, frames, label_path=args.label_path, sigma=args.sigma,
        opacity=args.opacity, blend_alg=args.blend_alg, iters=args.iters,
        padding_mode=args.padding_mode, batch=args.batch,
        classifier=classifier, cluster=args.cluster,
        no_flip_inference=args.no_flip_inference,
        out_dir=args.out, fps=args.fps,
        objects=args.objects or args.label_path is not None,
        save_correspondences=args.save_correspondences,
        resolution=args.resolution, save_frames=args.save_frames,
        average_path=args.average_path,
        overlay_congealed=args.overlay_congealed)
    print(f"Videos written to {args.out}")
    return result


if __name__ == "__main__":
    main()
