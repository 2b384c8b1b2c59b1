"""Grid sampling with torch.nn.functional.grid_sample semantics: a frozen
copy of the plain path of gangealing_torch/ops/grid_sample.py, with no
kernel. ``grid_sample`` is the plain
PyTorch version (bilinear and nearest, border / reflection / zeros padding,
either ``align_corners``).

The plain version differentiates as ``jax.grad`` of the JAX package's
``grid_sample`` does, ties included: an identity grid puts every point on an
integer coordinate and the first row and column on the border clamp.
"""

import torch


def jclip(x, lo, hi):
    """``jnp.clip`` with its gradient: min(max(x, lo), hi) against tensors,
    so a value on a bound passes half the gradient (``Tensor.clamp`` passes
    all of it). The values equal ``x.clamp(lo, hi)``."""
    lo_t = torch.full((), lo, dtype=x.dtype, device=x.device)
    hi_t = torch.full((), hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo_t), hi_t)


def jmax(x, lo):
    """``jnp.maximum(x, lo)`` for a constant ``lo``, with its gradient: half
    at a tie (``clamp_min`` passes all of it)."""
    return torch.maximum(x, torch.full((), lo, dtype=x.dtype, device=x.device))


def jabs(x):
    """``jnp.abs`` with its gradient: 1 at 0 (``Tensor.abs`` gives 0)."""
    return torch.where(x >= 0, x, -x)


def _unnormalize(coord, size, align_corners):
    if align_corners:
        return (coord + 1.0) * 0.5 * (size - 1)
    return ((coord + 1.0) * size - 1.0) * 0.5


def _reflect(coord, twice_low, twice_high):
    # Reflect coordinates into [twice_low/2, twice_high/2] (PyTorch algorithm).
    if twice_low == twice_high:
        return torch.zeros_like(coord)
    mn = twice_low / 2.0
    span = (twice_high - twice_low) / 2.0
    coord = jabs(coord - mn)
    extra = torch.remainder(coord, span)
    flips = torch.floor(coord / span)
    flipped = torch.remainder(flips, 2.0) != 0.0
    return torch.where(flipped, span - extra + mn, extra + mn)


def _compute_coords(coord, size, padding_mode, align_corners):
    """Unnormalize a coordinate from [-1, 1] and apply the padding rule."""
    c = _unnormalize(coord, size, align_corners)
    if padding_mode == "border":
        c = jclip(c, 0.0, size - 1)
    elif padding_mode == "reflection":
        if align_corners:
            c = _reflect(c, 0, 2 * (size - 1))
        else:
            c = _reflect(c, -1, 2 * size - 1)
        c = jclip(c, 0.0, size - 1)
    elif padding_mode != "zeros":
        raise ValueError(f"unknown padding_mode: {padding_mode}")
    return c


def _gather_2d(img_flat, idx):
    """img_flat: (N, C, H*W); idx: (N, P) int64 -> (N, C, P)."""
    N, C, _ = img_flat.shape
    return torch.gather(img_flat, 2, idx[:, None, :].expand(N, C, idx.shape[1]))


def grid_sample(input, grid, mode="bilinear", padding_mode="border",
                align_corners=False):
    """Sample ``input`` (N, C, H, W) at ``grid`` (N, Ho, Wo, 2) locations.

    grid[..., 0] is x in [-1, 1] over width; grid[..., 1] is y over height.
    Returns (N, C, Ho, Wo). Matches torch.nn.functional.grid_sample.
    """
    if mode not in ("bilinear", "nearest"):
        raise ValueError(f"unsupported mode: {mode}")
    N, C, H, W = input.shape
    _, Ho, Wo, _ = grid.shape
    gx = grid[..., 0].float().reshape(N, Ho * Wo)
    gy = grid[..., 1].float().reshape(N, Ho * Wo)
    x = _compute_coords(gx, W, padding_mode, align_corners)
    y = _compute_coords(gy, H, padding_mode, align_corners)
    img = input.float().reshape(N, C, H * W)

    if mode == "nearest":
        xi = torch.round(x).long()
        yi = torch.round(y).long()
        valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        out = _gather_2d(img, yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1))
        if padding_mode == "zeros":
            out = out * valid[:, None, :].float()
        return out.reshape(N, C, Ho, Wo).to(input.dtype)

    x0 = torch.floor(x)
    y0 = torch.floor(y)
    x1 = x0 + 1.0
    y1 = y0 + 1.0
    wx1 = x - x0
    wx0 = 1.0 - wx1
    wy1 = y - y0
    wy0 = 1.0 - wy1

    def corner(xc, yc, wxc, wyc):
        w = wxc * wyc
        if padding_mode == "zeros":
            valid = (xc >= 0) & (xc < W) & (yc >= 0) & (yc < H)
            w = w * valid.float()
        xi = xc.clamp(0, W - 1).long()
        yi = yc.clamp(0, H - 1).long()
        return _gather_2d(img, yi * W + xi) * w[:, None, :]

    out = (corner(x0, y0, wx0, wy0) + corner(x1, y0, wx1, wy0)
           + corner(x0, y1, wx0, wy1) + corner(x1, y1, wx1, wy1))
    return out.reshape(N, C, Ho, Wo).to(input.dtype)


def affine_grid(theta, size, align_corners=False):
    """Generate a sampling grid from affine matrices.

    theta: (N, 2, 3); size: (N, C, H, W) tuple. Returns (N, H, W, 2).
    Matches torch.nn.functional.affine_grid.
    """
    N, _, H, W = size
    kw = dict(dtype=theta.dtype, device=theta.device)
    if align_corners:
        xs = torch.linspace(-1.0, 1.0, W, **kw)
        ys = torch.linspace(-1.0, 1.0, H, **kw)
    else:
        xs = (torch.arange(W, **kw) * 2.0 + 1.0) / W - 1.0
        ys = (torch.arange(H, **kw) * 2.0 + 1.0) / H - 1.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")  # (H, W)
    t = theta[:, :, :, None, None]  # (N, 2, 3, 1, 1)
    out_x = t[:, 0, 0] * gx + t[:, 0, 1] * gy + t[:, 0, 2]
    out_y = t[:, 1, 0] * gx + t[:, 1, 1] * gy + t[:, 1, 2]
    return torch.stack([out_x, out_y], dim=-1)  # (N, H, W, 2)


def identity_grid(N, H, W, dtype=torch.float32, device=None,
                  align_corners=False):
    """The identity sampling grid, shape (N, H, W, 2)."""
    eye = torch.eye(2, 3, dtype=dtype, device=device).expand(N, 2, 3)
    return affine_grid(eye, (N, 1, H, W), align_corners=align_corners)
