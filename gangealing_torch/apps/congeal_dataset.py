"""Align and filter a raw dataset with the similarity STN stage.

Port of gangealing_tpu/apps/congeal_dataset.py (reference
applications/congeal_dataset.py:21-107), on one device or over ranks. Per
image: border-pad
to square (no resize) for sampling, and a flow_size version for
regression; infer flips; a similarity-only forward with the out-of-bounds
check; accept if the effective resolution (sqrt(det M) * min(w, h)) is high
enough and the warp stayed in bounds; write the accepted aligned PNGs, then
an LMDB of them.

The images go through in batches (the tail at its own size); accept and
reject happen on the host from the returned scales and bounds checks.
"""

import glob
import io
import os

import numpy as np
import torch

from gangealing_torch.apps.common import determine_flips, resolve_device
from gangealing_torch.apps.flow_scores import filter_dataset
from gangealing_torch.data.dataset import MultiResolutionDataset
from gangealing_torch.data.prepare import border_pad, create_dataset
from gangealing_torch.models.stn import make_3x3
from gangealing_torch.ops.resample import interpolate_bilinear
from gangealing_torch.parallel.mesh import (
    all_gatherv_hosts, host_barrier, is_primary, process_stripe, rank,
    world_size)


def congeal_batch(model, x_in, x_big, image_bounds, output_resolution,
                  iters=1, padding_mode="border", no_flip_inference=False):
    """(x_in (N, 3, fs, fs), x_big (N, 3, S, S), bounds (N, 2)) on the
    model's device -> (aligned, scale, oob): flip inference on ``x_in``,
    then the similarity stage regressed from it and applied to ``x_big``."""
    x_in_f, flips, _, _ = determine_flips(
        model, x_in, no_flip_inference=no_flip_inference, iters=iters,
        padding_mode=padding_mode)
    x_big_f = torch.where(flips, x_big.flip(3), x_big)
    aligned, _, M, oob = model.stns[0](
        x_in_f, iters=iters, input_img_for_sampling=x_big_f,
        output_resolution=output_resolution, return_out_of_bounds=True,
        image_bounds=image_bounds, padding_mode=padding_mode)
    scale = torch.sqrt(torch.linalg.det(make_3x3(M)))
    return aligned, scale, oob


def _to_float(arr_uint8_hwc):
    x = arr_uint8_hwc.astype(np.float32) / 255.0
    return (x * 2.0 - 1.0).transpose(2, 0, 1)


class _RawDataset(MultiResolutionDataset):
    """The LMDB's images as PIL RGB images, undecoded until asked for."""

    def __getitem__(self, index):
        from PIL import Image
        return Image.open(io.BytesIO(self.raw_bytes(index))).convert("RGB")


def _native_canvas(dataset):
    """The largest side of the dataset's images, rounded up to a multiple
    of 8: the one canvas the batches of the native-size mode share."""
    from PIL import Image
    canvas = 8
    base = dataset.dataset if hasattr(dataset, "dataset") else dataset
    idxs = (dataset.indices if hasattr(dataset, "indices")
            else range(len(dataset)))
    for i in idxs:
        # Image.open reads only the header; .size decodes no pixel data
        w, h = Image.open(io.BytesIO(base.raw_bytes(i))).size
        canvas = max(canvas, w, h)
    return (canvas + 7) // 8 * 8


def align_and_filter_dataset(model, data_path, out, real_size=256,
                             flow_size=128, output_resolution=256, iters=1,
                             padding_mode="border", batch=16,
                             min_effective_resolution=192,
                             flow_scores_path=None, fraction_retained=1.0,
                             no_flip_inference=False, device="cuda"):
    """Returns the sorted list of retained dataset indices; writes the
    aligned LMDB to ``out`` with its dataset_indices.pt.

    ``model`` runs on ``device``, the card unless the caller asks for the
    CPU (it is moved there). ``real_size`` 0 is the reference's native-size
    mode (README.md:227-232: images stored unresized under '0-' keys, each
    padded to its own square): batching needs one canvas, so the images
    are border-padded to their own square and bilinearly placed on the
    dataset's largest square, rounded up to a multiple of 8.

    Over ranks each rank aligns its stride of the dataset and writes its
    accepted PNGs into the shared folder under its own file-name prefix
    (the reference's chr(ord('a') + rank), congeal_dataset.py:29-38), the
    used indices are gathered (all_gatherv), and rank 0 alone builds the
    LMDB; every rank returns all the indices. The LMDB holds the same
    images as a one-rank run's, each rank's in a block of its own."""
    from PIL import Image
    device = resolve_device(device)
    model = model.to(device)
    temp_folder = f"{out}_imagefolder"
    os.makedirs(temp_folder, exist_ok=True)
    os.makedirs(out, exist_ok=True)
    # Stale PNGs of an earlier run over the same ``out`` would be baked into
    # the new LMDB by create_dataset's '*.png' glob while
    # dataset_indices.pt lists only this run's indices.
    if is_primary():
        for f in glob.glob(os.path.join(temp_folder, "*.png")):
            os.remove(f)
    host_barrier("congeal_dataset_clean")

    dataset = _RawDataset(data_path, resolution=real_size)
    if flow_scores_path is not None:
        dataset = filter_dataset(dataset, flow_scores_path, fraction_retained)
        index_map = dataset.indices
    else:
        index_map = list(range(len(dataset)))
    canvas = real_size or _native_canvas(dataset)

    prefix = chr(ord("a") + rank()) if world_size() > 1 else ""
    stripe = process_stripe(len(dataset))
    used_indices = []
    total = 0
    for start in range(0, len(stripe), batch):
        idxs = stripe[start:start + batch]
        x_in, x_big, bounds = [], [], []
        for i in idxs:
            img = dataset[i]
            w, h = img.size
            big = torch.from_numpy(_to_float(np.asarray(
                border_pad(img, max(w, h), resize=False, to_pil=False))))
            if big.shape[-1] != canvas:
                big = interpolate_bilinear(big[None], canvas, canvas)[0]
            x_big.append(big)
            x_in.append(torch.from_numpy(_to_float(np.asarray(
                border_pad(img, flow_size, to_pil=False)))))
            bounds.append([h, w])
        with torch.inference_mode():
            aligned, scale, oob = congeal_batch(
                model, torch.stack(x_in).to(device),
                torch.stack(x_big).to(device),
                torch.tensor(bounds, dtype=torch.float32, device=device),
                output_resolution, iters=iters, padding_mode=padding_mode,
                no_flip_inference=no_flip_inference)
        aligned = aligned.cpu().numpy()
        scale, oob = scale.cpu().numpy(), oob.cpu().numpy()
        for j, i in enumerate(idxs):
            h, w = bounds[j]
            too_low_res = scale[j] * min(w, h) < min_effective_resolution
            if too_low_res or oob[j]:
                continue
            used_indices.append(index_map[i])
            arr = np.clip((aligned[j] + 1) / 2, 0, 1)
            arr = (arr * 255 + 0.5).clip(0, 255).astype(np.uint8)
            Image.fromarray(arr.transpose(1, 2, 0)).save(
                f"{temp_folder}/{prefix}{total:07}.png")
            total += 1
    used_indices = sorted(all_gatherv_hosts(
        np.asarray(used_indices, np.int64)).tolist())
    host_barrier("congeal_dataset_pngs")  # every PNG on disk before the LMDB
    if is_primary():
        create_dataset(out, temp_folder, size=output_resolution,
                       format="png", pattern="*.png", progress=False)
        torch.save(torch.tensor(used_indices), f"{out}/dataset_indices.pt")
    host_barrier("congeal_dataset_lmdb")  # the LMDB whole before any reader
    return used_indices
