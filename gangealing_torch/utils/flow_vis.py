"""Optical-flow -> RGB visualization (Middlebury color wheel), batched.

The port's own copy of gangealing_tpu/utils/flow_vis.py, in numpy (reference
utils/vis_tools/flow_vis.py:22-130, itself the standard public Baker et al.
color-coding). Flows are scaled by (H - 1) before coloring, matching
flow_vis.py:118.
"""

import numpy as np


def _make_colorwheel():
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((ncols, 3), np.float32)
    col = 0
    # RY
    wheel[0:RY, 0] = 255
    wheel[0:RY, 1] = np.floor(255 * np.arange(RY) / RY)
    col += RY
    # YG
    wheel[col:col + YG, 0] = 255 - np.floor(255 * np.arange(YG) / YG)
    wheel[col:col + YG, 1] = 255
    col += YG
    # GC
    wheel[col:col + GC, 1] = 255
    wheel[col:col + GC, 2] = np.floor(255 * np.arange(GC) / GC)
    col += GC
    # CB
    wheel[col:col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col:col + CB, 2] = 255
    col += CB
    # BM
    wheel[col:col + BM, 2] = 255
    wheel[col:col + BM, 0] = np.floor(255 * np.arange(BM) / BM)
    col += BM
    # MR
    wheel[col:col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col:col + MR, 0] = 255
    return wheel


_WHEEL = _make_colorwheel()


def flow_to_rgb(flow, clip_flow=None, scale_by_resolution=True,
                per_sample_normalize=False):
    """(N, H, W, 2) normalized flow -> (N, H, W, 3) uint8 RGB.

    ``per_sample_normalize=False`` (default) normalizes the color intensity
    by the radius max over the WHOLE batch, exactly like the reference
    (flow_vis.py:124-127) — flows are comparable across a grid. True
    normalizes each sample independently (every frame at full saturation)."""
    flow = np.asarray(flow, np.float32)
    if flow.ndim == 3:
        flow = flow[None]
    N, H, W, _ = flow.shape
    if scale_by_resolution:
        flow = flow * (H - 1.0)
    u, v = flow[..., 0].copy(), flow[..., 1].copy()
    if clip_flow is not None:
        u = np.clip(u, 0, clip_flow)
        v = np.clip(v, 0, clip_flow)
    rad = np.sqrt(u ** 2 + v ** 2)
    if per_sample_normalize:
        rad_max = rad.reshape(N, -1).max(axis=1).reshape(N, 1, 1)
    else:
        rad_max = rad.max()
    eps = 1e-5
    u = u / (rad_max + eps)
    v = v / (rad_max + eps)

    rad = np.sqrt(u ** 2 + v ** 2)
    a = np.arctan2(-v, -u) / np.pi
    ncols = _WHEEL.shape[0]
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(np.int32)
    k1 = (k0 + 1) % ncols
    f = fk - k0
    img = np.zeros((N, H, W, 3), np.uint8)
    for c in range(3):
        col0 = _WHEEL[k0, c] / 255.0
        col1 = _WHEEL[k1, c] / 255.0
        col = (1 - f) * col0 + f * col1
        idx = rad <= 1
        col[idx] = 1 - rad[idx] * (1 - col[idx])
        col[~idx] = col[~idx] * 0.75
        img[..., c] = np.floor(255 * col).astype(np.uint8)
    return img
