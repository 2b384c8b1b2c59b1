"""Dataset building and frame loading.

The port's own copy of gangealing_tpu/data/prepare.py: images, SPair, CUB
or an LSUN LMDB into a multi-resolution LMDB (reference prepare_data.py:
pad modes :33-120, keypoint pre-processing :123-160, SPair loader
:198-250, CUB/ACSM loader :163-195, resize workers :253-314,
prepare/create_dataset :317-384; utils/CUB_data_utils.py for the ACSM bbox
utilities with python2 rounding), written through data/lmdb_io.py's bulk
writer in one pass; and the frame readers of the video apps
(``nchw_center_crop``, ``list_frame_paths``, ``load_frame_paths``,
``load_video_frames``), whose frames are float32 numpy arrays
(T, C, H, W) in [-1, 1]. PIL, cv2, scipy and pandas are imported inside
the functions that need them.
"""

import io
import json
import os
import re
from glob import glob

import numpy as np

from gangealing_torch.data.lmdb_io import LMDBReader, iterate_keys, write_lmdb

_IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")

# Key point index permutations applied when an image is mirrored
# (prepare_data.py:22-30).
CUB_PERMUTATION = [0, 1, 2, 3, 4, 5, 10, 11, 12, 9, 6, 7, 8, 13, 14]
SPAIR_PERMUTATIONS = {
    "bicycle": [0, 1, 3, 2, 4, 5, 7, 6, 8, 10, 9, 11],
    "cat": [1, 0, 3, 2, 5, 4, 7, 6, 8, 10, 9, 12, 11, 13, 14],
    "dog": [1, 0, 3, 2, 5, 4, 6, 7, 8, 10, 9, 12, 11, 13, 14, 15],
    "tvmonitor": [2, 1, 0, 7, 6, 5, 4, 3, 10, 9, 8, 15, 14, 13, 12, 11],
}


def _resize(img, wh):
    from PIL import Image
    return img.resize(wh, Image.LANCZOS)


def black_bar_pad(img, target_res, resize=True, to_pil=True):
    """Zero padding to square (prepare_data.py:33-50)."""
    from PIL import Image
    canvas = np.zeros([target_res, target_res, 3], dtype=np.uint8)
    ow, oh = img.size
    if oh <= ow:
        if resize:
            img = _resize(img, (target_res,
                                int(np.around(target_res * oh / ow))))
        width, height = img.size
        arr = np.asarray(img)
        canvas[(width - height) // 2:(width + height) // 2] = arr
    else:
        if resize:
            img = _resize(img, (int(np.around(target_res * ow / oh)),
                                target_res))
        width, height = img.size
        arr = np.asarray(img)
        canvas[:, (height - width) // 2:(height + width) // 2] = arr
    return Image.fromarray(canvas) if to_pil else canvas


def border_pad(img, target_res, resize=True, to_pil=True):
    """Edge-replication padding to square (prepare_data.py:53-77)."""
    from PIL import Image
    ow, oh = img.size
    if oh <= ow:
        if resize:
            img = _resize(img, (target_res,
                                int(np.around(target_res * oh / ow))))
        width, height = img.size
        arr = np.asarray(img)
        half = (target_res - height) / 2
        lh = int(half)
        rh = lh + (half > lh)
        arr = np.pad(arr, mode="edge", pad_width=[(lh, rh), (0, 0), (0, 0)])
    else:
        if resize:
            img = _resize(img, (int(np.around(target_res * ow / oh)),
                                target_res))
        width, height = img.size
        arr = np.asarray(img)
        half = (target_res - width) / 2
        lw = int(half)
        rw = lw + (half > lw)
        arr = np.pad(arr, mode="edge", pad_width=[(0, 0), (lw, rw), (0, 0)])
    return Image.fromarray(arr) if to_pil else arr


def center_crop(img, target_res):
    """StyleGAN2 LSUN crop (prepare_data.py:80-88)."""
    from PIL import Image
    arr = np.asarray(img)
    crop = np.min(arr.shape[:2])
    arr = arr[(arr.shape[0] - crop) // 2:(arr.shape[0] + crop) // 2,
              (arr.shape[1] - crop) // 2:(arr.shape[1] + crop) // 2]
    return _resize(Image.fromarray(arr, "RGB"), (target_res, target_res))


def resize_small_side(img, target_res):
    w, h = img.size
    if w < h:
        new_w, new_h = target_res, h * target_res // w
    else:
        new_h, new_w = target_res, w * target_res // h
    return _resize(img, (new_w, new_h))


# --- ACSM / CUB bbox utilities (utils/CUB_data_utils.py) -------------------

def python2_round(n):
    from decimal import localcontext, Decimal, ROUND_HALF_UP
    with localcontext() as ctx:
        ctx.rounding = ROUND_HALF_UP
        return Decimal(n).to_integral_value()


def perturb_bbox(bbox, pf=0.0, jf=0.0):
    out = [c for c in bbox]
    bw = bbox[2] - bbox[0] + 1
    bh = bbox[3] - bbox[1] + 1
    out[0] -= pf * bw + (1 - 2 * np.random.random()) * jf * bw
    out[1] -= pf * bh + (1 - 2 * np.random.random()) * jf * bh
    out[2] += pf * bw + (1 - 2 * np.random.random()) * jf * bw
    out[3] += pf * bh + (1 - 2 * np.random.random()) * jf * bh
    return out


def square_bbox(bbox, py2_round=True):
    rf = python2_round if py2_round else round
    sq = [int(rf(c)) for c in bbox]
    bw = sq[2] - sq[0] + 1
    bh = sq[3] - sq[1] + 1
    maxdim = float(max(bw, bh))
    sq[0] -= int(rf((maxdim - bw) / 2.0))
    sq[1] -= int(rf((maxdim - bh) / 2.0))
    sq[2] = sq[0] + maxdim - 1
    sq[3] = sq[1] + maxdim - 1
    return sq


def acsm_crop(img, bbox, bgval=0, border=True, py2_round=True):
    rf = python2_round if py2_round else round
    bbox = [int(rf(c)) for c in bbox]
    bw = bbox[2] - bbox[0] + 1
    bh = bbox[3] - bbox[1] + 1
    im_h, im_w = img.shape[0], img.shape[1]
    nc = 1 if img.ndim < 3 else img.shape[2]
    x0, x1 = max(0, bbox[0]), min(im_w, bbox[2] + 1)
    y0, y1 = max(0, bbox[1]), min(im_h, bbox[3] + 1)
    xt0 = x0 - bbox[0]
    yt0 = y0 - bbox[1]
    if border:
        crop = img[y0:y1, x0:x1, :]
        out = np.pad(crop, mode="edge",
                     pad_width=[(yt0, bh - (y1 - y0) - yt0),
                                (xt0, bw - (x1 - x0) - xt0), (0, 0)])
        return out
    out = np.ones((bh, bw, nc), dtype=np.uint8) * bgval
    out[yt0:yt0 + (y1 - y0), xt0:xt0 + (x1 - x0), :] = img[y0:y1, x0:x1, :]
    return out


def cub_crop(img, target_res, bbox):
    from PIL import Image
    arr = acsm_crop(np.asarray(img), bbox, 0, border=True)
    return _resize(Image.fromarray(arr), (target_res, target_res))


# --- key point pre-processing (prepare_data.py:123-160) --------------------

def preprocess_kps_pad(kps, img_width, img_height, size):
    kps = np.array(kps, dtype=np.float32, copy=True)
    scale = size / max(img_width, img_height)
    kps[:, [0, 1]] *= scale
    if img_height < img_width:
        new_h = int(np.around(size * img_height / img_width))
        offset_y = int((size - new_h) / 2)
        offset_x = 0
        kps[:, 1] += offset_y
    elif img_width < img_height:
        new_w = int(np.around(size * img_width / img_height))
        offset_x = int((size - new_w) / 2)
        offset_y = 0
        kps[:, 0] += offset_x
    else:
        offset_x = offset_y = 0
    kps *= kps[:, 2:3]  # zero-out non-visible key points
    return kps, offset_x, offset_y, scale


def preprocess_kps_box_crop(kps, bbox, size):
    kps = np.array(kps, dtype=np.float32, copy=True)
    kps[:, 0] -= bbox[0] + 1
    kps[:, 1] -= bbox[1] + 1
    w = 1 + bbox[2] - bbox[0]
    h = 1 + bbox[3] - bbox[1]
    assert w == h
    kps[:, [0, 1]] *= size / float(w)
    return kps


# --- source loaders ---------------------------------------------------------

def load_image_folder(path, pattern="*.png"):
    files = sorted(glob(os.path.join(path, pattern)))
    return files, [None] * len(files)


def load_spair_data(path, size, out_path, category="cat", split="test"):
    """SPair-71K pair annotations -> files + sidecar tensors
    (prepare_data.py:198-250)."""
    import torch
    pairs = sorted(glob(f"{path}/PairAnnotation/{split}/*:{category}.json"))
    files, thresholds, inverse, kps = [], [], [], []
    category_anno = list(glob(f"{path}/ImageAnnotation/{category}/*.json"))[0]
    with open(category_anno) as f:
        num_kps = len(json.load(f)["kps"])
    for pair in pairs:
        with open(pair) as f:
            data = json.load(f)
        assert category == data["category"] and data["mirror"] == 0
        src_fn = f'{path}/JPEGImages/{category}/{data["src_imname"]}'
        trg_fn = f'{path}/JPEGImages/{category}/{data["trg_imname"]}'
        sb = np.asarray(data["src_bndbox"])
        tb = np.asarray(data["trg_bndbox"])
        thresholds.append(max(sb[3] - sb[1], sb[2] - sb[0]))
        thresholds.append(max(tb[3] - tb[1], tb[2] - tb[0]))
        src_size = data["src_imsize"][:2]
        trg_size = data["trg_imsize"][:2]
        kp_ixs = np.asarray([int(i) for i in data["kps_ids"]])

        def scatter_kps(raw):
            blank = np.zeros((num_kps, 3), np.float32)
            raw = np.concatenate([np.asarray(raw, np.float32),
                                  np.ones((len(kp_ixs), 1), np.float32)], 1)
            blank[kp_ixs] = raw
            return blank

        skps, sx, sy, ss = preprocess_kps_pad(scatter_kps(data["src_kps"]),
                                              src_size[0], src_size[1], size)
        tkps, tx, ty, ts = preprocess_kps_pad(scatter_kps(data["trg_kps"]),
                                              trg_size[0], trg_size[1], size)
        kps.extend([skps, tkps])
        files.extend([src_fn, trg_fn])
        inverse.extend([[sx, sy, ss], [tx, ty, ts]])
    kps = np.stack(kps)
    used = np.where(kps[:, :, 2].any(axis=0))[0]
    kps = kps[:, used, :]
    n = len(thresholds)
    torch.save(torch.arange(n).view(n // 2, 2), f"{out_path}/pairs.pt")
    torch.save(torch.tensor(thresholds, dtype=torch.float),
               f"{out_path}/pck_thresholds.pt")
    torch.save(torch.tensor(inverse), f"{out_path}/inverse_coordinates.pt")
    torch.save(torch.from_numpy(kps), f"{out_path}/keypoints.pt")
    torch.save(SPAIR_PERMUTATIONS[category], f"{out_path}/permutation.pt")
    return files, [None] * len(files)


def load_cub_keypoints(path):
    import pandas as pd
    names = ["img_index", "kp_index", "x", "y", "visible"]
    lm = pd.read_table(path, header=None, names=names, sep=r"\s+",
                       engine="python")
    return lm.to_numpy().reshape((11788, 15, 5))[..., [2, 3, 4]].astype(
        np.float32)


def load_acsm_data(path, mat_path="data/val_cub_cleaned.mat", size=256,
                   out_path=None):
    """CUB via ACSM pre-processing (prepare_data.py:171-195)."""
    import torch
    from scipy.io import loadmat
    mat = loadmat(mat_path)
    files = [f"{path}/images/{f[0]}" for f in mat["images"]["rel_path"][0]]
    indices = [i[0, 0] - 1 for i in mat["images"]["id"][0]]
    kps = load_cub_keypoints(f"{path}/parts/part_locs.txt")[indices]
    bboxes, kps_out = [], []
    for ix, row in enumerate(mat["images"]["bbox"][0]):
        x1, y1, x2, y2 = row[0, 0]
        bbox = np.array([x1[0, 0], y1[0, 0], x2[0, 0], y2[0, 0]]) - 1
        bbox = perturb_bbox(bbox, 0.05, 0)
        bbox = square_bbox(bbox)
        bboxes.append(bbox)
        kps_out.append(preprocess_kps_box_crop(kps[ix], bbox, size))
    torch.save(torch.from_numpy(np.stack(kps_out)),
               f"{out_path}/keypoints.pt")
    torch.save(CUB_PERMUTATION, f"{out_path}/permutation.pt")
    return files, np.stack(bboxes)


# --- building a dataset ----------------------------------------------------

def resize_and_convert(img, size, pad, quality=100, format="jpeg", bbox=None):
    if pad == "zero":
        img = black_bar_pad(img, size)
    elif pad == "border":
        img = border_pad(img, size)
    elif pad == "center":
        img = center_crop(img, size)
    elif pad == "none":
        pass
    elif pad == "resize_small_side":
        img = resize_small_side(img, size)
    elif pad == "cub_crop":
        img = cub_crop(img, size, bbox)
    else:
        raise NotImplementedError(pad)
    buf = io.BytesIO()
    img.save(buf, format=format, quality=quality)
    return buf.getvalue()


def _encode_file(f, bbox, sizes, pad, format):
    """Decode + resize + encode one image at every size; None on failure."""
    from PIL import Image
    try:
        img = Image.open(f).convert("RGB")
        return [resize_and_convert(img, s, pad, format=format, bbox=bbox)
                for s in sizes]
    except Exception as e:  # corrupted image -> skip (prepare_data:308)
        print(f"skipping image {f}: {e}")
        return None


def _encode_bytes(data, sizes, pad, format):
    """Decode raw encoded bytes + resize + encode; None on failure."""
    from PIL import Image
    try:
        try:
            import cv2
            arr = cv2.imdecode(np.frombuffer(data, np.uint8), 1)
            if arr is None:
                raise IOError("cv2.imdecode failed")
            img = Image.fromarray(arr[:, :, ::-1])
        except Exception:
            img = Image.open(io.BytesIO(data)).convert("RGB")
        return [resize_and_convert(img, s, pad, format=format)
                for s in sizes]
    except Exception as e:
        print(f"skipping image: {e}")
        return None


def _parallel_map(fn, jobs, workers):
    """Ordered map over jobs with a thread pool (PIL/cv2 codecs release the
    GIL, so threads parallelize the decode/resize/encode work — the
    capability of the reference's multiprocessing pool,
    prepare_data.py:253-314, without pickling overhead)."""
    if workers and workers > 1:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=workers) as pool:
            return list(pool.map(fn, jobs))
    return [fn(j) for j in jobs]


def default_build_workers():
    return min(8, os.cpu_count() or 1)


def create_dataset(out, path, size, pad="zero", format="jpeg",
                   input_is_lmdb=False, pattern="*.png", max_images=None,
                   spair_category=None, spair_split=None, cub_acsm=False,
                   files=None, bboxes=None, progress=True, workers=None):
    """Build a multi-resolution LMDB (prepare_data.py:317-384).
    ``size`` may be an int or comma-separated list of ints. ``workers``
    threads parallelize decode/resize/encode (default: min(8, cpus));
    output is byte-identical to the sequential build."""
    sizes = [int(s.strip()) for s in str(size).split(",")]
    os.makedirs(out, exist_ok=True)
    if files is None:
        if input_is_lmdb:
            # LSUN path (prepare_data.py:292-331): the input is itself an
            # LMDB of encoded images
            return create_dataset_from_lmdb(
                out, path, size, pad=pad, format=format,
                max_images=max_images, progress=progress, workers=workers)
        if cub_acsm:
            files, bboxes = load_acsm_data(path, size=sizes[0], out_path=out)
        elif spair_category is not None:
            files, bboxes = load_spair_data(path, size=sizes[0], out_path=out,
                                            category=spair_category,
                                            split=spair_split)
        else:
            files, bboxes = load_image_folder(path, pattern)
    if bboxes is None:
        bboxes = [None] * len(files)
    if max_images is not None:
        files, bboxes = files[:max_images], bboxes[:max_images]

    if workers is None:
        workers = default_build_workers()
    results = _parallel_map(
        lambda job: _encode_file(job[0], job[1], sizes, pad, format),
        list(zip(files, bboxes)), workers)

    items = {}
    total = 0
    for encs in results:
        if encs is None:
            continue
        for s, enc in zip(sizes, encs):
            items[f"{s}-{str(total).zfill(5)}".encode()] = enc
        total += 1
    items[b"length"] = str(total).encode()
    write_lmdb(out, items)
    if progress:
        print(f"Final dataset size: {total}")
    return total


def lmdb_file_iterator(lmdb_path, max_images=None):
    """Enumerate (index, key) from an input LMDB (LSUN-style) for
    create_dataset (prepare_data.py:321-331)."""
    keys = [k for k in iterate_keys(lmdb_path) if k != b"length"]
    if max_images is not None:
        keys = keys[:max_images]
    return keys


def create_dataset_from_lmdb(out, lmdb_path, size, pad="center",
                             format="jpeg", max_images=None, progress=True,
                             workers=None):
    """Build a multi-resolution LMDB from an input LMDB of encoded images
    (the LSUN path of prepare_data.py:292-331). Raw bytes are fetched in the
    main thread; decode/resize/encode runs on ``workers`` threads."""
    sizes = [int(s.strip()) for s in str(size).split(",")]
    os.makedirs(out, exist_ok=True)
    reader = LMDBReader(lmdb_path)
    keys = lmdb_file_iterator(lmdb_path, max_images)
    if workers is None:
        workers = default_build_workers()
    raw = [reader.get(k) for k in keys]
    results = _parallel_map(
        lambda data: _encode_bytes(data, sizes, pad, format), raw, workers)
    items = {}
    total = 0
    for encs in results:
        if encs is None:
            continue
        for s, enc in zip(sizes, encs):
            items[f"{s}-{str(total).zfill(5)}".encode()] = enc
        total += 1
    items[b"length"] = str(total).encode()
    write_lmdb(out, items)
    if progress:
        print(f"Final dataset size: {total}")
    return total


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
