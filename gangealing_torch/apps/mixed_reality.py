"""Mixed reality: propagate a congealed-space RGBA object onto every frame
of a video (augmented-reality "object lenses").

Port of gangealing_tpu/apps/mixed_reality.py (reference
applications/mixed_reality.py:83-300), on one device or over ranks. Per
batch of frames: center-crop to a square, decide the flips, uncongeal the
label's points, splat and blend them onto the frames, and congeal the
frames for the congealed video. Over ranks each rank renders its stride of
the frames (the reference's rank striding, mixed_reality.py:28-33), the
frames are gathered back in order, and rank 0 alone writes the videos.

Memory modes (reference :213-216, :239-243, :258-262):
  * ``save_frames=True`` writes each frame as a PNG to <out>/frames and
    <out>/congealing_frames instead of holding the video in host memory,
    then assembles the mp4s from the files;
  * ``frames`` may be a (T, C, H, W) array or a list of image paths (a
    frame directory), loaded one batch at a time.
A clustering model runs with its cluster classifier, which picks each
frame's cluster and flip (or only the flip within ``cluster``); with
``average_path`` it adds the cluster-activity video, average.mp4: each
cluster's average congealed image with the label splatted on it, the
frame's cluster bright and the others dimmed (reference :58-70, :120-128,
:245-256).
"""

import os

import numpy as np
import torch

from gangealing_torch.apps.common import determine_flips
from gangealing_torch.data.prepare import load_frame_paths, nchw_center_crop
from gangealing_torch.models.stn import (
    composed_uncongeal_points, convert_points)
from gangealing_torch.parallel.mesh import (
    gather_process_stripes, host_barrier, is_primary, process_stripe)
from gangealing_torch.utils.vis import (
    get_colorscale, images2grid, load_dense_label, load_pil, save_video,
    splat_points)

_INACTIVE_ALPHA = 0.2  # the dimming of the inactive clusters (reference :86)


def _save_frame_png(frame_chw, path):
    """Write one (C, H, W) [-1, 1] frame as a PNG."""
    from PIL import Image
    arr = ((np.asarray(frame_chw) + 1.0) * 127.5).clip(0, 255)
    Image.fromarray(arr.transpose(1, 2, 0).astype(np.uint8)).save(path)


def _labeled_average_images(average_path, num_heads, points, resolution,
                            sigma, opacity):
    """Each cluster's average congealed image with the label's points
    splatted on it in the cluster's colorscale (reference
    create_average_image_vis, :58-70). The images are named ...cluster0.png,
    ...cluster1.png and so on; ``average_path`` names the first. Returns
    (K, C, H, W) on the points' device."""
    imgs = []
    for k in range(num_heads):
        avg = load_pil(average_path.replace("cluster0", f"cluster{k}"),
                       resolution=resolution).to(points.device)
        imgs.append(splat_points(avg, points.float(), sigma=sigma,
                                 opacity=opacity,
                                 colorscale=get_colorscale(k)))
    return torch.cat(imgs, 0)


def _batch_of(frames, lazy_paths, blk, device):
    """The frames of indices ``blk`` as a float32 tensor on ``device``."""
    if lazy_paths is not None:
        fb = load_frame_paths([lazy_paths[i] for i in blk])
        if fb.shape[-1] != fb.shape[-2]:
            fb, _ = nchw_center_crop(fb)
        fb = torch.from_numpy(np.ascontiguousarray(fb))
    else:
        fb = frames[blk]
    return fb.to(device=device, dtype=torch.float32)


def run_gangealing_on_video(model, frames, label_path=None, points=None,
                            colors=None, alphas=None, sigma=1.2, opacity=1.0,
                            blend_alg="alpha", iters=1, padding_mode="border",
                            batch=4, classifier=None, cluster=None,
                            no_flip_inference=False, out_dir=None, fps=30,
                            objects=True, save_correspondences=False,
                            resolution=None, save_frames=False,
                            average_path=None, overlay_congealed=False):
    """``model``: a ComposedSTN on the device to run on. ``frames``:
    (T, C, H, W) in [-1, 1] (numpy or torch), or a list of image file paths
    loaded one batch at a time; any H, W, center-cropped to a square.
    ``points``, ``colors``, ``alphas``: a dense label as
    ``load_dense_label`` returns it, in place of ``label_path``.

    ``classifier``: the cluster classifier of a clustering model (or None);
    ``cluster``: the one cluster to run every frame through.

    Returns a dict of numpy arrays: 'propagated' and 'congealed'
    (T, C, S, S), left out when ``save_frames`` (the frames go to disk),
    and 'correspondences' (T, P, 2) when ``save_correspondences``; and
    'average_frames', a list of (H, W, C) uint8 grids, with a classifier,
    ``average_path`` and a label. Writes propagated.mp4 and congealed.mp4
    (and correspondences.pt, average.mp4) when ``out_dir`` is given.

    Over ranks every rank returns all the frames and rank 0 writes the
    files; with ``save_frames`` each rank writes the PNGs of its own
    frames, named by their global index."""
    if classifier is None and model.cfg.num_heads > 1:
        raise ValueError("a clustering model needs its cluster classifier")
    device = next(model.parameters()).device
    lazy_paths = None
    if isinstance(frames, (list, tuple)) and frames and isinstance(
            frames[0], str):
        lazy_paths = list(frames)
        T = len(lazy_paths)
    else:
        frames = torch.as_tensor(frames)
        if frames.shape[-1] != frames.shape[-2]:
            frames, _ = nchw_center_crop(frames)
        T = frames.shape[0]

    if save_frames:
        if out_dir is None:
            raise ValueError("save_frames=True needs out_dir")
        os.makedirs(os.path.join(out_dir, "frames"), exist_ok=True)
        os.makedirs(os.path.join(out_dir, "congealing_frames"), exist_ok=True)

    if points is None and label_path is not None and objects:
        points, colors, alphas = load_dense_label(
            label_path, resolution=resolution, load_colors=True)
    if points is not None:
        points, colors, alphas = (torch.as_tensor(t, device=device)
                                  for t in (points, colors, alphas))

    K = model.cfg.num_heads
    averages = None
    if classifier is not None and K > 1 and average_path is not None \
            and points is not None:
        averages = _labeled_average_images(average_path, K, points,
                                           resolution, sigma, opacity)
        inactive = averages * _INACTIVE_ALPHA - (1 - _INACTIVE_ALPHA)

    stripe = process_stripe(T)
    propagated, congealed, correspondences, average_frames = [], [], [], []
    for s in range(0, len(stripe), batch):
        blk = stripe[s:s + batch]  # the global indices of the batch
        fb = _batch_of(frames, lazy_paths, blk, device)
        n = fb.shape[0]
        S = fb.shape[-1]
        with torch.inference_mode():
            flipped, flip_idx, warp_policy, clusters = determine_flips(
                model, fb, classifier=classifier, cluster=cluster,
                no_flip_inference=no_flip_inference, iters=iters,
                padding_mode=padding_mode)
            if objects and points is not None:
                prop_pts = composed_uncongeal_points(
                    model, flipped, points.repeat(n, 1, 1),
                    normalize_input_points=True,
                    unnormalize_output_points=True, iters=iters,
                    padding_mode=padding_mode, warp_policy=warp_policy)
                # un-flip the points of the frames that were mirrored
                prop_x = torch.where(flip_idx.reshape(n, 1),
                                     S - 1 - prop_pts[..., 0],
                                     prop_pts[..., 0])
                prop_pts = torch.stack([prop_x, prop_pts[..., 1]], dim=-1)
                out = splat_points(
                    fb, prop_pts, sigma=sigma, opacity=opacity,
                    colors=colors.repeat(n, 1, 1),
                    alpha_channel=alphas.repeat(n, 1, 1),
                    blend_alg=blend_alg).cpu().numpy()
                if save_frames:
                    for j in range(n):
                        _save_frame_png(out[j], os.path.join(
                            out_dir, "frames", f"{blk[j]}.png"))
                else:
                    propagated.append(out)
                if save_correspondences:
                    correspondences.append(prop_pts.cpu().numpy())
            cong, _, _, _, _ = model(flipped, output_resolution=S,
                                     iters=iters, padding_mode=padding_mode,
                                     warp_policy=warp_policy)
            if overlay_congealed and points is not None:
                # the input label on the congealed frames
                # (reference mixed_reality.py:245-252)
                res = resolution or S
                cong_pts = (convert_points(points, res, S) if res != S
                            else points)
                cong = splat_points(
                    cong, cong_pts.repeat(n, 1, 1), sigma=sigma,
                    opacity=opacity, colors=colors.repeat(n, 1, 1),
                    alpha_channel=alphas.repeat(n, 1, 1))
            cong = cong.cpu().numpy()
        if save_frames:
            for j in range(n):
                _save_frame_png(cong[j], os.path.join(
                    out_dir, "congealing_frames", f"{blk[j]}.png"))
        else:
            congealed.append(cong)
        if averages is not None:
            # the cluster-activity frames: the frame's cluster highlighted
            active = torch.eye(K, dtype=torch.bool,
                               device=device)[clusters]
            for j in range(n):
                current = torch.where(active[j].reshape(-1, 1, 1, 1),
                                      averages, inactive)
                average_frames.append(images2grid(
                    current, normalize=True, range=(-1, 1), pad_value=-1.0,
                    nrow=max(1, int(np.ceil(K ** 0.5)))))

    result = {}
    if not save_frames:
        result["congealed"] = gather_process_stripes(congealed, T)
        if objects and points is not None:
            result["propagated"] = gather_process_stripes(propagated, T)
    if save_correspondences and points is not None and objects:
        result["correspondences"] = gather_process_stripes(correspondences, T)
    if averages is not None:
        average_frames = list(gather_process_stripes(
            [np.stack(average_frames)] if average_frames else [], T))
    if out_dir is not None and save_frames:
        host_barrier("mixed_reality_frames")  # every PNG on disk first
    if out_dir is not None and is_primary():
        _write_videos(result, out_dir, T, fps, save_frames)
        if average_frames:
            save_video(average_frames, fps,
                       os.path.join(out_dir, "average.mp4"))
    if average_frames:
        result["average_frames"] = average_frames
    return result


def _write_videos(result, out_dir, T, fps, save_frames):
    os.makedirs(out_dir, exist_ok=True)
    if save_frames:
        import cv2
        for sub, name in (("frames", "propagated.mp4"),
                          ("congealing_frames", "congealed.mp4")):
            files = [os.path.join(out_dir, sub, f"{i}.png") for i in range(T)]
            files = [f for f in files if os.path.isfile(f)]
            if files:
                save_video([cv2.imread(f)[:, :, ::-1] for f in files], fps,
                           os.path.join(out_dir, name))
    else:
        if "propagated" in result:
            save_video(result["propagated"], fps,
                       os.path.join(out_dir, "propagated.mp4"),
                       input_is_tensor=True)
        save_video(result["congealed"], fps,
                   os.path.join(out_dir, "congealed.mp4"),
                   input_is_tensor=True)
    if "correspondences" in result:
        torch.save(torch.from_numpy(result["correspondences"]),
                   os.path.join(out_dir, "correspondences.pt"))
