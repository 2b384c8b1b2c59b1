"""Dataset-building CLI (port of gangealing_tpu/cli/prepare_data.py;
reference prepare_data.py).

    python -m gangealing_torch.cli.prepare_data --out data/cats \
        --path images/ --size 256

It runs on the host (PIL decodes, resizes and encodes on worker threads),
so it takes no ``--device``; its flags are the JAX package's.
"""

import argparse
import os


def prepare_data_argparse():
    p = argparse.ArgumentParser(description="Create image datasets")
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--path", type=str, required=True)
    p.add_argument("--size", type=str, default="256")
    p.add_argument("--pad", type=str, default="zero",
                   choices=["zero", "border", "center", "none",
                            "resize_small_side", "cub_crop"])
    p.add_argument("--format", type=str, default="jpeg",
                   choices=["jpeg", "png"])
    p.add_argument("--pattern", type=str, default="*.png")
    p.add_argument("--max_images", type=int, default=None)
    p.add_argument("--spair_category", type=str, default=None)
    p.add_argument("--spair_split", type=str, default="test")
    p.add_argument("--cub_acsm", action="store_true")
    p.add_argument("--workers", "--n_worker", dest="workers", type=int,
                   default=None,
                   help="decode/resize/encode threads "
                        "(default: min(8, cpus); reference "
                        "prepare_data.py:253-314 uses a worker pool)")
    p.add_argument("--input_is_lmdb", action="store_true",
                   help="path points at an existing LMDB (e.g. an LSUN "
                        "export); --pattern is ignored "
                        "(prepare_data.py:414-416)")
    p.add_argument("--lsun_category", type=str, default=None,
                   help="LSUN category name; resolves data/lsun/<category> "
                        "(the reference downloads it; here the LMDB must "
                        "already be on disk)")
    return p


def main(argv=None):
    """Build the dataset the flags describe; returns its image count."""
    args = prepare_data_argparse().parse_args(argv)
    if args.lsun_category is not None:
        lsun_path = os.path.join("data", "lsun", args.lsun_category)
        if not os.path.isdir(lsun_path):
            raise SystemExit(
                f"--lsun_category: expected an LSUN LMDB at {lsun_path} "
                "(place the export there, or pass --path <lmdb> "
                "--input_is_lmdb)")
        args.path, args.input_is_lmdb = lsun_path, True

    from gangealing_torch.data.prepare import create_dataset
    return create_dataset(args.out, args.path, args.size, pad=args.pad,
                          format=args.format, pattern=args.pattern,
                          input_is_lmdb=args.input_is_lmdb,
                          max_images=args.max_images,
                          spair_category=args.spair_category,
                          spair_split=args.spair_split,
                          cub_acsm=args.cub_acsm, workers=args.workers)


if __name__ == "__main__":
    main()
