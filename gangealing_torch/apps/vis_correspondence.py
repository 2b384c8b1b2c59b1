"""Correspondence visualization videos.

Port of gangealing_tpu/apps/vis_correspondence.py (reference
applications/vis_correspondence.py:32-437) without its mesh arguments:
smooth congealing videos (the warp lerped from the identity by alpha over
time), dense correspondence and edit propagation videos, per-cluster
bucketing of real images and average-image videos. Every function runs on
the device of the model (or classifier) it is given; frames are made on
the host as (H, W, 3) uint8 grids. Over ranks the average-image video sums
each rank's stride of the images and the bucketing gathers each rank's
assignments; the smooth videos render on one rank.
"""

import math
import os

import numpy as np
import torch
import torch.nn.functional as F

from gangealing_torch.apps.common import determine_flips
from gangealing_torch.models.classifier import classifier_assign
from gangealing_torch.models.stn import (
    composed_uncongeal_points, convert_points, normalize_points,
    sample_grid_at_points, unnormalize_points)
from gangealing_torch.ops.grid_sample import identity_grid
from gangealing_torch.ops.mipmap import mipmap_warp
from gangealing_torch.ops.resample import interpolate_bilinear
from gangealing_torch.parallel.mesh import (
    all_gather_hosts, gather_process_stripes, is_primary, process_stripe,
    world_size)
from gangealing_torch.utils.vis import (
    images2grid, load_dense_label, save_video, splat_points)

# Elements of the patch distances that nearest_neighbor_within_patch holds
# at once (4 bytes each, and twice that for the patches themselves): a
# dense 256^2 label over 4 images in 37 x 37 windows would otherwise gather
# 2.9 GB a frame.
NN_CHUNK_ELEMENTS = 1 << 24


def _device(module):
    return next(module.parameters()).device


def _on(x, device):
    return torch.as_tensor(x).to(device=device, dtype=torch.float32)


def interpolation_alphas(num_frames, pause_frames=0):
    """Smooth 0->1 cosine ramp with optional end pauses."""
    t = np.linspace(0.0, 1.0, num_frames)
    alphas = 0.5 - 0.5 * np.cos(np.pi * t)
    if pause_frames:
        alphas = np.concatenate([np.zeros(pause_frames), alphas,
                                 np.ones(pause_frames)])
    return alphas.astype(np.float32)


@torch.no_grad()
def smooth_congeal_video(model, images, num_frames=60, iters=1,
                         padding_mode="border", out_path=None, fps=30,
                         no_flip_inference=True, grid_nrow=None):
    """Animate identity -> full congealing warp through the heads' alpha.
    images: (N, C, S, S)."""
    images = _on(images, _device(model))
    N, C, S, _ = images.shape
    flipped, _, _, _ = determine_flips(model, images,
                                       no_flip_inference=no_flip_inference,
                                       iters=iters, padding_mode=padding_mode)
    frames = []
    for a in interpolation_alphas(num_frames):
        out, _, _, _, _ = model(
            flipped, output_resolution=S, iters=iters,
            alpha=torch.full((N,), float(a), device=images.device),
            padding_mode=padding_mode)
        frames.append(images2grid(out, nrow=grid_nrow or max(1, int(N ** 0.5)),
                                  normalize=True, range=(-1, 1)))
    if out_path is not None:
        save_video(frames, fps, out_path)
    return frames


@torch.no_grad()
def smooth_propagation_video(model, images, label_path, num_frames=60,
                             sigma=1.2, opacity=1.0, iters=1,
                             padding_mode="border", out_path=None, fps=30,
                             no_flip_inference=True, resolution=None):
    """Animate the propagated label fading in over the images."""
    dev = _device(model)
    images = _on(images, dev)
    N, C, S, _ = images.shape
    points, colors, alphas_lbl = (t.to(dev) for t in load_dense_label(
        label_path, resolution=resolution, load_colors=True))
    flipped, flip_idx, _, _ = determine_flips(
        model, images, no_flip_inference=no_flip_inference, iters=iters,
        padding_mode=padding_mode)
    prop = composed_uncongeal_points(
        model, flipped, points.repeat(N, 1, 1), normalize_input_points=True,
        unnormalize_output_points=True, iters=iters,
        padding_mode=padding_mode)
    fi = flip_idx.reshape(N, 1)
    prop = torch.stack([torch.where(fi, S - 1 - prop[..., 0], prop[..., 0]),
                        prop[..., 1]], -1)
    frames = []
    for a in interpolation_alphas(num_frames):
        out = splat_points(images, prop, sigma=sigma, opacity=float(a),
                           colors=colors.repeat(N, 1, 1),
                           alpha_channel=alphas_lbl.repeat(N, 1, 1))
        frames.append(images2grid(out, nrow=max(1, int(N ** 0.5)),
                                  normalize=True, range=(-1, 1)))
    if out_path is not None:
        save_video(frames, fps, out_path)
    return frames


@torch.no_grad()
def average_image_video(model, images, num_frames=60, iters=1,
                        padding_mode="border", out_path=None, fps=30,
                        batch=16):
    """Animate the average congealed image sharpening as alpha goes 0->1
    (vis_correspondence.py:335-437): each frame sums the warped images in
    batches of ``batch`` on the device and averages them on the host.

    Over ranks each rank sums its stride of the images, the partial sums
    are summed over the ranks (the reference's per-rank shards and
    all_gather mean, vis_correspondence.py:338-379), and rank 0 writes the
    video; every rank returns the frames."""
    dev = _device(model)
    images = torch.as_tensor(images)
    N, C, S, _ = images.shape
    stripe = process_stripe(N)
    frames = []
    for a in interpolation_alphas(num_frames):
        acc = np.zeros((C, S, S), np.float32)
        for s in range(0, len(stripe), batch):
            xb = _on(images[stripe[s:s + batch]], dev)
            out, _, _, _, _ = model(
                xb, output_resolution=S, iters=iters,
                alpha=torch.full((xb.shape[0],), float(a), device=dev),
                padding_mode=padding_mode)
            acc += out.sum(0).cpu().numpy()
        if world_size() > 1:
            acc = all_gather_hosts(acc).sum(axis=0)
        frames.append(images2grid((acc / N)[None], nrow=1, normalize=True))
    if out_path is not None and is_primary():
        save_video(frames, fps, out_path)
    return frames


@torch.no_grad()
def bucket_real_images_by_cluster(classifier, images, num_heads, batch=32):
    """Assign real images to clusters with the cluster classifier
    (vis_correspondence.py:301-332). Returns a list of index arrays, one
    a cluster. Over ranks each rank classifies its stride of the images
    and the assignments are gathered back in image order."""
    dev = _device(classifier)
    images = torch.as_tensor(images)
    N = images.shape[0]
    stripe = process_stripe(N)
    assignments = [classifier_assign(
        classifier, _on(images[stripe[s:s + batch]], dev),
        ignore_flips=True).cpu().numpy() for s in range(0, len(stripe), batch)]
    assignments = gather_process_stripes(assignments, N)
    return [np.where(assignments == k)[0] for k in range(num_heads)]


def pad_grid(grid):
    """Linearly extrapolate a sampling grid one pixel beyond each border
    (vis_correspondence.py:59-76). (N, H, W, 2) -> (N, H+2, W+2, 2)."""
    g = F.pad(grid.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="replicate")
    g = g.permute(0, 2, 3, 1).clone()
    right = 2 * g[:, :, -2] - g[:, :, -3]
    left = 2 * g[:, :, 1] - g[:, :, 2]
    bottom = 2 * g[:, -2] - g[:, -3]
    top = 2 * g[:, 1] - g[:, 2]
    g[:, 0] = top
    g[:, -1] = bottom
    g[:, :, 0] = left
    g[:, :, -1] = right
    return g


def get_patch_size(length):
    """Window-size heuristic for patch-restricted NN tracking
    (vis_correspondence.py:173-181): fewer frames => larger per-frame motion
    => bigger search window. Always odd."""
    patch_size = math.ceil(9 * max(1, 240 / length))
    return patch_size + 1 if patch_size % 2 == 0 else patch_size


def nearest_neighbor_within_patch(grid, points, patch_centers, patch_size):
    """For each point, the grid location within a ``patch_size`` window
    around its patch center whose value lies nearest in L2
    (vis_correspondence.py:80-114); the first in row-major window order
    at a tie. grid (N, H, W, 2), points (N, P, 2), patch_centers (N, P, 2)
    integer (x, y). Returns (N, P, 2) integer (x, y) coords into the
    unpadded grid. The points go in chunks of as many as keep
    NN_CHUNK_ELEMENTS distances, so memory stays bounded."""
    N, H, W, _ = grid.shape
    P = points.shape[1]
    Hp, Wp = H + 2, W + 2
    g = pad_grid(grid).reshape(N, Hp * Wp, 2)
    half = patch_size // 2
    centers = patch_centers.long() + 1  # into the padded grid
    off = torch.arange(-half, half + 1, device=grid.device)
    oy, ox = torch.meshgrid(off, off, indexing="ij")  # (ps, ps)
    chunk = max(1, NN_CHUNK_ELEMENTS // (N * patch_size ** 2))
    picks = []
    for s in range(0, P, chunk):
        c = centers[:, s:s + chunk]
        n = c.shape[1]
        py = (c[..., 1, None, None] + oy).clamp(0, Hp - 1)
        px = (c[..., 0, None, None] + ox).clamp(0, Wp - 1)
        flat = (py * Wp + px).reshape(N, -1, 1).expand(-1, -1, 2)
        patches = g.gather(1, flat).reshape(N, n, patch_size ** 2, 2)
        diff = patches - points[:, s:s + chunk, None, :]
        d = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
        picks.append(d.argmin(dim=-1))
    nn_idx = torch.cat(picks, 1)  # (N, P)
    ny = nn_idx // patch_size - half
    nx = nn_idx % patch_size - half
    return torch.stack([centers[..., 0] + nx - 1, centers[..., 1] + ny - 1],
                       dim=-1)


# ---------------------------------------------------------------------------
# the assembled dense-tracking pipeline (vis_correspondence.py:226-298)
# ---------------------------------------------------------------------------

def _flip_grid(grid, flip_indices):
    """Negate the x sampling coordinate of flipped images
    (vis_correspondence.py:166-169). grid: (N, H, W, 2)."""
    sign = torch.where(flip_indices.reshape(-1, 1, 1), -1.0, 1.0)
    return torch.stack([grid[..., 0] * sign, grid[..., 1]], dim=-1)


def _resize_grid(grid, out_res):
    """Bilinearly resize an (N, H, W, 2) sampling grid."""
    if grid.shape[1] == out_res:
        return grid
    g = interpolate_bilinear(grid.permute(0, 3, 1, 2), out_res, out_res)
    return g.permute(0, 2, 3, 1)


def _smooth_stage(grid_to, grid_from, data, length, nrow, points=None,
                  patch_centers=None, padding_mode="border"):
    """Interpolate grid_from -> grid_to over ``length`` frames, warping
    ``data`` and, with ``points``, tracking them by patch-restricted NN
    (vis_correspondence.py:184-208). Returns (frames, tracked points
    (T, N, P, 2) or None, congealed images (T, N, C, R, R), the last patch
    centers)."""
    # cap the NN window at the grid's extent: the heuristic explodes for
    # tiny lengths (get_patch_size(4) = 541), and a window larger than the
    # grid searches all of it anyway
    R = grid_to.shape[1]
    patch_size = min(get_patch_size(length), (R // 2) * 2 + 1)
    frames, out_points, out_images = [], [], []
    for fi in range(length):
        a = float(1.0 - 0.5 * (1.0 + np.cos(np.pi * fi / (length - 1))))
        grid_t = grid_from + a * (grid_to - grid_from)
        congealed = mipmap_warp(data, grid_t, padding_mode=padding_mode)
        frames.append(images2grid(congealed, nrow=nrow, normalize=True,
                                  range=(-1, 1)))
        out_images.append(congealed)
        if points is not None:
            patch_centers = nearest_neighbor_within_patch(
                grid_t, points, patch_centers, patch_size)
            out_points.append(patch_centers.float())
    out_points = torch.stack(out_points) if out_points else None
    return frames, out_points, torch.stack(out_images), patch_centers


@torch.no_grad()
def visualize_label_propagation(images, propagated_points, colors,
                                alpha_channels, images_per_frame,
                                output_resolution, sigma=1.2, opacity=0.7,
                                splat_batch=100, colorscale="turbo",
                                initial_frames=(), out_path=None, fps=60):
    """Splat the tracked points onto each frame's congealed images in
    chunks of ``splat_batch``, grid them and reverse the sequence
    (vis_correspondence.py:133-158). images: (T, N, C, R, R);
    propagated_points: (T, N, P, 2); colors (1, P, 3) or None (the
    colorscale), alpha_channels (1, P, 1)."""
    T_N = images.shape[0] * images.shape[1]
    assert T_N % images_per_frame == 0
    dev = images.device
    images = images.reshape(-1, 3, output_resolution, output_resolution)
    pts = propagated_points.reshape(-1, propagated_points.shape[2], 2)
    colors_rep = colors.to(dev).repeat(splat_batch, 1, 1) \
        if colors is not None else None
    alpha_rep = alpha_channels.to(dev).repeat(splat_batch, 1, 1)
    chunks = []
    for i in range(0, images.shape[0], splat_batch):
        n = min(splat_batch, images.shape[0] - i)
        chunks.append(splat_points(
            images[i:i + n], pts[i:i + n], sigma=sigma, opacity=opacity,
            colorscale=colorscale,
            colors=colors_rep[:n] if colors is not None else None,
            alpha_channel=alpha_rep[:n]).cpu().numpy())
    splatted = np.concatenate(chunks, 0).reshape(
        -1, images_per_frame, 3, output_resolution, output_resolution)
    nrow = max(1, int(images_per_frame ** 0.5))
    frames = list(initial_frames)
    for frame in splatted:
        frames.append(images2grid(frame, nrow=nrow, normalize=True,
                                  range=(-1, 1)))
    frames = frames[::-1]  # play congealed -> unaligned
    if out_path is not None:
        save_video(frames, fps, out_path)
    return frames


def visualize_correspondence(congealing_frames, propagation_frames,
                             out_path=None, fps=60, pause_steps=60,
                             interp_steps=60, end_pause_steps=5):
    """The congeal-then-propagate video (vis_correspondence.py:118-131)."""
    last = np.asarray(congealing_frames[-1], np.float32)
    first_prop = np.asarray(propagation_frames[0], np.float32)
    interp = [np.clip(last + a * (first_prop - last), 0, 255)
              .round().astype(np.uint8)
              for a in np.linspace(0, 1, interp_steps)]
    full = (list(congealing_frames)
            + [congealing_frames[-1]] * pause_steps + interp
            + list(propagation_frames)
            + [propagation_frames[-1]] * end_pause_steps)
    if out_path is not None:
        save_video(full, fps, out_path)
    return full


@torch.no_grad()
def smoothly_congeal_and_propagate(model, images, label_path=None, length=60,
                                   iters=1, padding_mode="border",
                                   output_resolution=None, resolution=None,
                                   vis_in_stages=False, sigma=1.2,
                                   opacity=0.7, splat_batch=100,
                                   no_flip_inference=False, objects=False,
                                   out_dir=None, fps=60, classifier=None,
                                   cluster=None, stage_flip=False,
                                   flip_length=40):
    """The reference's correspondence video (vis_correspondence.py:226-298):
    animate identity -> congealing warp (each stage apart with
    ``vis_in_stages``, the mirror flip first with ``stage_flip``); with a
    dense label, track its pixels through the animation by patch-NN
    search forward from the unaligned frame and in reverse from the
    congealed frame, lerped frame by frame (:279-287), splat them in
    chunks of ``splat_batch`` (:477), and write smoothly_congeal.mp4,
    smoothly_propagate.mp4 and smooth_correspondence.mp4 into ``out_dir``.
    ``classifier``: a clustering model's cluster classifier (or None).

    Returns (congealing frames, propagation frames or None)."""
    dev = _device(model)
    data = _on(images, dev)
    N, C, S, _ = data.shape
    R = output_resolution or S
    nrow = max(1, int(N ** 0.5))

    data_flipped, flip_idx, warp_policy, _ = determine_flips(
        model, data, classifier=classifier, cluster=cluster,
        no_flip_inference=no_flip_inference, iters=iters,
        padding_mode=padding_mode)
    flip_vec = flip_idx.reshape(N)

    intermediates = model(data_flipped, iters=iters, warp_policy=warp_policy,
                          padding_mode=padding_mode, return_intermediates=True)
    stage_grids = [g for (_, g) in intermediates]
    if not vis_in_stages:
        stage_grids = [stage_grids[-1]]
    stage_grids = [_flip_grid(_resize_grid(g, R), flip_vec)
                   for g in stage_grids]

    ident = identity_grid(N, R, R, device=dev)
    flipping_grid = _flip_grid(ident, flip_vec)
    grids = [flipping_grid] + stage_grids  # stage i: grids[i] -> grids[i+1]
    num_stages = len(grids) - 1

    # the dense label -> the first tracked points in the unaligned space
    if label_path is not None:
        points, colors, alpha_channels = load_dense_label(
            label_path, resolution=resolution, load_colors=objects)
        res = resolution or points_resolution_default(points)
        pts = points.to(dev).repeat(N, 1, 1)
        colors = colors.to(dev) if colors is not None else None
        alpha_channels = alpha_channels.to(dev)
        unaligned_norm = sample_grid_at_points(grids[-1],
                                               normalize_points(pts, R, res))
        unaligned = unnormalize_points(unaligned_norm, R, R)
        patch_centers = unaligned.round().clamp(0, R - 1).int()
        # patch centers live in output pixel space: mirror them for the
        # flipped images (the grids already sample the unflipped source;
        # reference vis_correspondence.py:250-252)
        fv = flip_vec.reshape(N, 1)
        patch_centers = torch.stack(
            [torch.where(fv, R - 1 - patch_centers[..., 0],
                         patch_centers[..., 0]), patch_centers[..., 1]], -1)
        tracked = unaligned_norm  # the NN search is in normalized space
        congealed_centers = (convert_points(pts, res, R) if res != R
                             else pts).round().int()
    else:
        tracked = patch_centers = colors = alpha_channels = None
        congealed_centers = None

    congealed_frames, propagated_points, congealed_images = [], [], []
    initial_propagation_frames = []
    if stage_flip:
        # animate identity -> mirror before the first warp stage
        # (reference make_flip_frames, vis_correspondence.py:161-163,261-271)
        flip_frames, _, _, _ = _smooth_stage(flipping_grid, ident, data,
                                             flip_length, nrow,
                                             padding_mode=padding_mode)
        congealed_frames.extend(flip_frames)
        if label_path is not None:
            splatted = splat_points(
                mipmap_warp(data, ident, padding_mode=padding_mode),
                unnormalize_points(unaligned_norm, R, R), sigma=sigma,
                opacity=opacity,
                colors=(colors.repeat(N, 1, 1) if objects
                        and colors is not None else None),
                alpha_channel=alpha_channels.repeat(N, 1, 1))
            initial_propagation_frames, _, _, _ = _smooth_stage(
                flipping_grid, ident, splatted, flip_length, nrow,
                padding_mode=padding_mode)
    for i in range(num_stages):
        frames_i, pts_i, imgs_i, patch_centers = _smooth_stage(
            grids[i + 1], grids[i], data, length, nrow, tracked,
            patch_centers, padding_mode)
        congealed_frames.extend(frames_i)
        propagated_points.append(pts_i)
        congealed_images.append(imgs_i)

    propagation_frames = None
    if label_path is not None:
        # bidirectional consistency (vis_correspondence.py:279-287): track
        # in reverse (congealed -> unaligned) and lerp the two by a frame's
        # alpha, so that the congealed end is pinned to the exact label
        alpha = torch.from_numpy(np.linspace(0.0, 1.0, length).astype(
            np.float32)).to(dev).reshape(length, 1, 1, 1)
        cc = congealed_centers
        for i in range(num_stages):
            _, rev_pts, _, cc = _smooth_stage(
                grids[-i - 2], grids[-i - 1], data, length, nrow, tracked,
                cc, padding_mode)
            fwd = propagated_points[-i - 1]
            propagated_points[-i - 1] = fwd + alpha * (rev_pts.flip(0) - fwd)
        propagation_frames = visualize_label_propagation(
            torch.cat(congealed_images, 0), torch.cat(propagated_points, 0),
            colors if objects else None, alpha_channels, N, R, sigma=sigma,
            opacity=opacity, splat_batch=splat_batch,
            initial_frames=initial_propagation_frames,
            out_path=(os.path.join(out_dir, "smoothly_propagate.mp4")
                      if out_dir else None), fps=fps)
        visualize_correspondence(
            congealed_frames, propagation_frames,
            out_path=(os.path.join(out_dir, "smooth_correspondence.mp4")
                      if out_dir else None), fps=fps)
    if out_dir is not None:
        save_video(congealed_frames, fps,
                   os.path.join(out_dir, "smoothly_congeal.mp4"))
    return congealed_frames, propagation_frames


def points_resolution_default(points):
    """Fallback label resolution: the tight power-of-2 bound of the
    coords."""
    m = float(torch.as_tensor(points).max()) + 1
    r = 1
    while r < m:
        r *= 2
    return r
