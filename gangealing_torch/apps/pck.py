"""PCK-Transfer evaluation, the paper's headline correctness metric.

Port of gangealing_tpu/apps/pck.py (reference applications/pck.py:18-175)
on one device. Protocol:
  * SPair-71K: fixed pairs, per-image alpha*bbox thresholds
    (threshB*scaleB), one-way unless ``transfer_both_ways``.
  * CUB: random pairs, alpha*max(H,W) threshold, bidirectional.
  * match_flows 4-way flip matching unless ``no_flip_inference``.

A batch runs the flip match (one forward at 4N) and, each way, the
congealing stages on the source images and one composed forward on the
targets whose grid is sampled at the points: K1 twice a forward, K2 once a
way on the card. The tail batch runs at its own size; the counts are summed
on the host.
"""

import os
from typing import Optional

import numpy as np
import torch

from gangealing_torch.apps.common import load_stn
from gangealing_torch.data.dataset import DataLoader, PCKDataset
from gangealing_torch.models.stn import (
    composed_match_flows, composed_transfer_points)


def pck_batch(model, imgsA, imgsB, kpsA, kpsB, visible, threshA, threshB,
              alphas, iters=1, padding_mode="border", match_flows=True,
              transfer_both_ways=True, permutation=None):
    """One batch of PCK-Transfer on the model's device.

    kps: (N, P, 2); visible: (N, P, 1); thresh*: (N,) pixel thresholds at
    alpha 1, or None for max(H, W) of the images. Returns the (A,) counts
    of correct transfers per alpha and the number of visible key points
    seen (times the number of ways)."""
    kw = dict(iters=iters, padding_mode=padding_mode)
    if match_flows:
        imgsA, imgsB, kpsA, kpsB, _ = composed_match_flows(
            model, imgsA, imgsB, kpsA, kpsB, permutation=permutation, **kw)
    alphas = torch.as_tensor(list(alphas), dtype=torch.float32,
                             device=imgsA.device).reshape(1, -1)
    vm = visible.float()

    def one_way(src_img, dst_img, src_kps, dst_kps, thresh):
        est = composed_transfer_points(model, src_img, dst_img, src_kps, **kw)
        err = torch.linalg.norm(est - dst_kps, dim=-1)[..., None]  # (N,P,1)
        thr = alphas * thresh[:, None]  # (N, A)
        correct = (err <= thr[:, None, :]).float()  # (N, P, A)
        return (correct * vm).sum(dim=(0, 1))  # (A,)

    if threshA is None:
        size = float(max(imgsB.shape[-2], imgsB.shape[-1]))
        threshA = torch.full((imgsA.shape[0],), size, device=imgsA.device)
        threshB = torch.full((imgsB.shape[0],), size, device=imgsB.device)
    correct = one_way(imgsA, imgsB, kpsA, kpsB, threshB)
    ways = 1
    if transfer_both_ways:
        correct = correct + one_way(imgsB, imgsA, kpsB, kpsA, threshA)
        ways = 2
    return correct, vm.sum() * ways


def batch_tensors(d, device):
    """A PCK loader batch as the tensors of ``pck_batch`` on ``device``:
    images, key points split from their visibility (the product of both
    images' flags), and the thresholds threshold * scale, or None."""
    kpsA = np.asarray(d["kpsA"], np.float32)
    kpsB = np.asarray(d["kpsB"], np.float32)
    if kpsA.shape[-1] == 3:
        visible = kpsA[..., 2:3] * kpsB[..., 2:3]
        kpsA, kpsB = kpsA[..., :2], kpsB[..., :2]
    else:
        visible = np.ones((*kpsA.shape[:2], 1), np.float32)
    thA = thB = None
    if "threshB" in d:
        thA = np.asarray(d["scaleA"], np.float32) * np.asarray(
            d["threshA"], np.float32)
        thB = np.asarray(d["scaleB"], np.float32) * np.asarray(
            d["threshB"], np.float32)
    arrays = [np.asarray(d["imgsA"], np.float32),
              np.asarray(d["imgsB"], np.float32), kpsA, kpsB, visible,
              thA, thB]
    return [None if a is None else torch.from_numpy(
        np.ascontiguousarray(a)).to(device) for a in arrays]


def pck_transfer(model, loader, alphas=(0.1,),
                 num_pairs: Optional[int] = None, iters=1,
                 padding_mode="border", match_flows=True,
                 transfer_both_ways=True, permutation=None, progress=False):
    """Run PCK-Transfer over ``loader`` (an iterable of dict batches) on the
    model's device. Returns an (A,) numpy array of PCK per alpha
    (applications/pck.py:104)."""
    device = next(model.parameters()).device
    correct = np.zeros(len(alphas), np.float64)
    kps_seen = 0.0
    pairs_seen = 0
    it = iter(loader)
    while num_pairs is None or pairs_seen < num_pairs:
        try:
            d = next(it)
        except StopIteration:
            break
        n = d["imgsA"].shape[0]
        if num_pairs is not None and pairs_seen + n > num_pairs:
            n = num_pairs - pairs_seen
            d = {k: v[:n] for k, v in d.items()}
        with torch.inference_mode():
            c, k = pck_batch(model, *batch_tensors(d, device), alphas,
                             iters=iters, padding_mode=padding_mode,
                             match_flows=match_flows,
                             transfer_both_ways=transfer_both_ways,
                             permutation=permutation)
        correct += c.cpu().numpy().astype(np.float64)
        kps_seen += float(k)
        pairs_seen += n
        if progress:
            print(f"\rpck pairs: {pairs_seen}", end="", flush=True)
    if progress:
        print()
    return correct / max(kps_seen, 1.0)


def vis_transfer(model, loader, permutation=None, out_dir="visuals",
                 num_to_vis=8, match_flows=True, iters=1,
                 padding_mode="border"):
    """Save a key point transfer visualization (applications/pck.py:77-100):
    the ground-truth key points on images A next to the transferred
    estimates on images B, both in their own orientation, as
    transfers/transfer_grid.png, and the congealed images as
    transfers/congealed.png. Returns the grid's path."""
    from PIL import Image
    from gangealing_torch.utils.vis import (
        batch_overlay, images2grid, save_image)

    device = next(model.parameters()).device
    d = next(iter(loader))
    n = min(num_to_vis, d["imgsA"].shape[0])

    def take(key, cols=None):
        a = np.asarray(d[key][:n], np.float32)
        a = a[..., :cols] if cols else a
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    imgsA, imgsB = take("imgsA"), take("imgsB")
    kpsA_orig, kpsB = take("kpsA", 2), take("kpsB", 2)
    kw = dict(iters=iters, padding_mode=padding_mode)
    with torch.inference_mode():
        if match_flows:
            imgsA_m, imgsB_m, kpsA, _, pick = composed_match_flows(
                model, imgsA, imgsB, kpsA_orig, kpsB,
                permutation=permutation, **kw)
        else:
            imgsA_m, imgsB_m, kpsA = imgsA, imgsB, kpsA_orig
            pick = torch.zeros((n,), dtype=torch.long, device=device)
        est_kpsB = composed_transfer_points(model, imgsA_m, imgsB_m, kpsA,
                                            **kw)
        W = imgsB.shape[-1]
        est_x = torch.where(pick.reshape(n, 1) > 1, W - 1 - est_kpsB[..., 0],
                            est_kpsB[..., 0])
        est_kpsB = torch.stack([est_x, est_kpsB[..., 1]], dim=-1)
        congealed, _, _, _, _ = model(torch.cat([imgsA_m, imgsB_m]),
                                      output_resolution=W, **kw)

    imgs = torch.cat([imgsA, imgsB]).cpu()  # originals, pre-flip
    kps = torch.cat([kpsA_orig, est_kpsB]).cpu()
    out_path = os.path.join(out_dir, "transfers")
    os.makedirs(out_path, exist_ok=True)
    overlaid = batch_overlay(imgs, kps, None, out_path, unique_color=True,
                             size=10)
    grid = images2grid(np.stack(overlaid).transpose(0, 3, 1, 2), nrow=n,
                       normalize=True, range=(0, 255))
    grid_path = os.path.join(out_path, "transfer_grid.png")
    Image.fromarray(grid).save(grid_path)
    congealed_path = os.path.join(out_path, "congealed.png")
    save_image(congealed.cpu(), congealed_path, nrow=n, normalize=True,
               range=(-1, 1))
    print(f"Saved visualization to {grid_path} and {congealed_path}")
    return grid_path


def run_pck(ckpt_path, data_path, alphas=(0.1, 0.05, 0.01), real_size=256,
            batch=50, iters=1, padding_mode="border", num_pairs=None,
            transfer_both_ways=False, no_flip_inference=False, seed=0,
            device="cuda"):
    """End to end: load the checkpoint onto ``device`` (the card unless the
    caller asks for the CPU) and evaluate PCK on an LMDB PCK dataset.

    ``transfer_both_ways`` defaults False, matching the reference CLI
    (applications/pck.py --transfer_both_ways store_true) and the one-way
    SPair protocol (reference README.md:207); pass True for CUB."""
    model, _ = load_stn(ckpt_path, supersize=real_size, device=device)
    dset = PCKDataset(data_path, resolution=real_size, seed=seed)
    if num_pairs is None:
        num_pairs = len(dset)
    loader = DataLoader(dset, batch_size=batch, shuffle=False,
                        drop_last=False)
    pck = pck_transfer(model, loader, alphas=alphas, num_pairs=num_pairs,
                       iters=iters, padding_mode=padding_mode,
                       match_flows=not no_flip_inference,
                       transfer_both_ways=transfer_both_ways,
                       permutation=dset.mirror_permutation, progress=True)
    for a, p in zip(alphas, pck):
        print(f"PCK-Transfer@{a}: {p * 100:.2f}%")
    return pck
