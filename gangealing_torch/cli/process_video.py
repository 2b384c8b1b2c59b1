"""Video -> multi-resolution frame LMDB (port of
gangealing_tpu/cli/process_video.py; reference process_video.sh).

    python -m gangealing_torch.cli.process_video --video clip.mp4 \
        --out data/clip --size 256

cv2 decodes the video in the process and each frame goes through
data/prepare.py's pad modes into data/lmdb_io.py's writer; it runs on the
host and takes the JAX package's flags only.
"""

import argparse
import os


def process_video_argparse():
    p = argparse.ArgumentParser(description="Process a video into an LMDB")
    p.add_argument("--video", type=str, required=True)
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--size", type=str, default="256")
    p.add_argument("--pad", type=str, default="center",
                   choices=["zero", "border", "center", "none",
                            "resize_small_side"])
    p.add_argument("--format", type=str, default="png")
    p.add_argument("--max_frames", type=int, default=None)
    return p


def main(argv=None):
    """Write the LMDB; returns the number of frames."""
    args = process_video_argparse().parse_args(argv)

    from PIL import Image
    import cv2
    from gangealing_torch.data.lmdb_io import write_lmdb
    from gangealing_torch.data.prepare import resize_and_convert

    sizes = [int(s.strip()) for s in args.size.split(",")]
    cap = cv2.VideoCapture(args.video)
    items = {}
    i = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        img = Image.fromarray(frame[:, :, ::-1])
        for s in sizes:
            items[f"{s}-{str(i).zfill(5)}".encode()] = resize_and_convert(
                img, s, args.pad, format=args.format)
        i += 1
        if args.max_frames is not None and i >= args.max_frames:
            break
    cap.release()
    items[b"length"] = str(i).encode()
    os.makedirs(args.out, exist_ok=True)
    write_lmdb(args.out, items)
    print(f"Wrote {i} frames to {args.out}")
    return i


if __name__ == "__main__":
    main()
