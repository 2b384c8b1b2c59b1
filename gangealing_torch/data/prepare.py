"""Frame loading for the video apps.

Port of the parts of gangealing_tpu/data/prepare.py that the AR path runs:
``nchw_center_crop`` (reference prepare_data.py:91-99) and the frame
readers (``list_frame_paths``, ``load_frame_paths``,
``load_video_frames``). Frames are float32 numpy arrays (T, C, H, W) in
[-1, 1]; cv2 is imported inside the functions that need it.
"""

import os
import re

import numpy as np

_IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


def nchw_center_crop(img):
    """Square center crop of an (N, C, H, W) array. Returns the crop and
    its (top, left) offset."""
    H, W = img.shape[2], img.shape[3]
    crop = min(H, W)
    top = (H - crop) // 2
    left = (W - crop) // 2
    return img[:, :, top:(H + crop) // 2, left:(W + crop) // 2], (top, left)


def list_frame_paths(directory):
    """Image paths of a frame directory in numeric order (2.png before
    10.png), the reference's frames/<index>.png layout
    (mixed_reality.py:258-259)."""
    def key(name):
        nums = re.findall(r"\d+", name)
        return (int(nums[-1]) if nums else 0, name)

    names = [n for n in os.listdir(directory)
             if n.lower().endswith(_IMAGE_EXTS)]
    return [os.path.join(directory, n) for n in sorted(names, key=key)]


def _to_frames(frames):
    arr = np.stack(frames).astype(np.float32) / 255.0
    return (arr * 2 - 1).transpose(0, 3, 1, 2)


def load_frame_paths(paths, resolution=None):
    """Load image files into (T, C, H, W) float32 frames in [-1, 1]."""
    import cv2
    frames = []
    for p in paths:
        frame = cv2.imread(p, cv2.IMREAD_COLOR)
        if frame is None:
            raise FileNotFoundError(f"cannot read an image from {p}")
        frame = frame[:, :, ::-1]  # BGR -> RGB
        if resolution is not None:
            frame = cv2.resize(frame, (resolution, resolution),
                               interpolation=cv2.INTER_AREA)
        frames.append(frame)
    return _to_frames(frames)


def load_video_frames(path, max_frames=None, resolution=None):
    """Decode a video file, or a directory of frames, into (T, C, H, W)
    float32 frames in [-1, 1] (through cv2)."""
    import cv2
    if os.path.isdir(path):
        paths = list_frame_paths(path)
        if max_frames is not None:
            paths = paths[:max_frames]
        return load_frame_paths(paths, resolution=resolution)
    cap = cv2.VideoCapture(path)
    frames = []
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frame = frame[:, :, ::-1]  # BGR -> RGB
            if resolution is not None:
                frame = cv2.resize(frame, (resolution, resolution),
                                   interpolation=cv2.INTER_AREA)
            frames.append(frame)
            if max_frames is not None and len(frames) >= max_frames:
                break
    finally:
        cap.release()
    if not frames:
        raise FileNotFoundError(f"no frames decoded from {path}")
    return _to_frames(frames)
