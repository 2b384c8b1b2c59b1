"""Congealing a set of images, their average congealed image, and edit
propagation onto each of them.

Port of gangealing_tpu/apps/propagate_to_images.py (reference
applications/propagate_to_images.py:44-104), on one device or over ranks:
the machinery of mixed_reality over an image set.
"""

import os

import torch

from gangealing_torch.apps.common import determine_flips
from gangealing_torch.models.stn import (
    composed_uncongeal_points, convert_points)
from gangealing_torch.parallel.mesh import (
    gather_process_stripes, is_primary, process_stripe)
from gangealing_torch.utils.vis import (
    load_dense_label, load_pil, save_image, splat_points)


def annotate_average(average_path, label_path, real_size, resolution,
                     output_resolution=None, sigma=1.3, opacity=0.75,
                     objects=False, out_dir=None):
    """Splat a congealed-space label onto a precomputed average congealed
    image (reference make_visuals, propagate_to_images.py:74-78): the
    average loads at ``real_size``; the label's points load at
    ``resolution`` and are converted to ``output_resolution``, which
    defaults to ``real_size`` (propagate_to_images.py:142-143). Returns the
    (1, 3, S, S) annotated image as numpy; writes average_annotated.png
    when ``out_dir`` is given."""
    out_res = output_resolution if output_resolution else real_size
    avg = load_pil(average_path, resolution=real_size)
    pts, colors, alphas = load_dense_label(label_path, resolution=resolution,
                                           load_colors=objects)
    pts = convert_points(pts, resolution, out_res)
    annotated = splat_points(avg, pts, sigma=sigma, opacity=opacity,
                             colorscale="plasma", colors=colors,
                             alpha_channel=alphas)
    if out_dir is not None:
        save_image(annotated, os.path.join(out_dir, "average_annotated.png"),
                   normalize=True, range=(-1, 1))
    return annotated.numpy()


def propagate_to_images(model, images, label_path=None, sigma=1.2,
                        opacity=1.0, blend_alg="alpha", iters=1,
                        padding_mode="border", batch=8, classifier=None,
                        cluster=None, no_flip_inference=False, out_dir=None,
                        resolution=None, objects=True,
                        output_resolution=None, average_n=None):
    """``model``: a ComposedSTN on the device to run on; ``images``:
    (N, C, S, S) in [-1, 1] (numpy or torch). Returns a dict of numpy
    arrays: 'congealed', 'average_congealed' and, with a label,
    'propagated'.

    ``objects``: take the propagated colors from the label's RGB channels;
    False splats the reference's 'plasma' colorscale
    (propagate_to_images.py make_visuals). ``output_resolution``: the size
    of the congealed outputs (default: the input size). ``average_n``: the
    number of leading images averaged into 'average_congealed' (reference
    --n_mean); 0 skips the average. ``classifier``: the cluster classifier
    of a clustering model, which picks each image's cluster and flip, or
    only the flip within ``cluster``.

    Over ranks each rank congeals its stride of the images (the
    reference's DistributedSampler striding, propagate_to_images.py:90-96);
    the results are gathered back in image order and only rank 0 writes
    files. Every rank returns all the results."""
    if classifier is None and model.cfg.num_heads > 1:
        raise ValueError("a clustering model needs its cluster classifier")
    device = next(model.parameters()).device
    images = torch.as_tensor(images)
    N, C, S, _ = images.shape
    out_res = output_resolution or S
    points = colors = alphas = None
    if label_path is not None:
        points, colors, alphas = load_dense_label(label_path,
                                                  resolution=resolution,
                                                  load_colors=objects)
        points, alphas = points.to(device), alphas.to(device)
        if colors is not None:
            colors = colors.to(device)
    stripe = process_stripe(N)
    congealed, propagated = [], []
    for s in range(0, len(stripe), batch):
        xb = images[stripe[s:s + batch]].to(device=device,
                                            dtype=torch.float32)
        n = xb.shape[0]
        with torch.inference_mode():
            flipped, flip_idx, warp_policy, _ = determine_flips(
                model, xb, classifier=classifier, cluster=cluster,
                no_flip_inference=no_flip_inference, iters=iters,
                padding_mode=padding_mode)
            cong, _, _, _, _ = model(flipped, output_resolution=out_res,
                                     iters=iters, padding_mode=padding_mode,
                                     warp_policy=warp_policy)
            congealed.append(cong.cpu().numpy())
            if points is None:
                continue
            prop_pts = composed_uncongeal_points(
                model, flipped, points.repeat(n, 1, 1),
                normalize_input_points=True, unnormalize_output_points=True,
                iters=iters, padding_mode=padding_mode,
                warp_policy=warp_policy)
            prop_x = torch.where(flip_idx.reshape(n, 1),
                                 S - 1 - prop_pts[..., 0], prop_pts[..., 0])
            prop_pts = torch.stack([prop_x, prop_pts[..., 1]], dim=-1)
            out = splat_points(
                xb, prop_pts, sigma=sigma, opacity=opacity,
                colors=colors.repeat(n, 1, 1) if colors is not None else None,
                colorscale="plasma", alpha_channel=alphas.repeat(n, 1, 1),
                blend_alg=blend_alg)
            propagated.append(out.cpu().numpy())

    result = {"congealed": gather_process_stripes(congealed, N)}
    if average_n is None or average_n > 0:
        avg_src = result["congealed"]
        if average_n is not None:
            avg_src = avg_src[:average_n]
        result["average_congealed"] = avg_src.mean(axis=0, keepdims=True)
    if points is not None:
        result["propagated"] = gather_process_stripes(propagated, N)
    if out_dir is not None and is_primary():
        os.makedirs(out_dir, exist_ok=True)
        save_image(result["congealed"], os.path.join(out_dir, "congealed.png"),
                   normalize=True, range=(-1, 1))
        if "average_congealed" in result:
            save_image(result["average_congealed"],
                       os.path.join(out_dir, "average_congealed.png"),
                       normalize=True, range=None)
        if "propagated" in result:
            save_image(result["propagated"],
                       os.path.join(out_dir, "propagated.png"),
                       normalize=True, range=(-1, 1))
    return result
