"""Grid sampling with torch.nn.functional.grid_sample semantics.

Port of gangealing_tpu/ops/grid_sample.py. ``grid_sample`` is the plain
PyTorch version (bilinear and nearest, border / reflection / zeros padding,
either ``align_corners``). ``grid_sample_auto`` takes it for CPU tensors and
on CUDA launches the bilinear kernels of csrc/grid_sample.cu through an
autograd Function: the forward (K2, which reads a contiguous or a
channels_last input as it lies) replaces
gangealing_tpu/ops/pallas_grid_sample.py::_fwd_kernel, its backward the
``_dcoords_kernel`` (K4, d/dgrid) and ``_dimg_kernel`` (K5b, d/dimage, a
deterministic binned gather).

The plain version differentiates as ``jax.grad`` of the JAX package's
``grid_sample`` does, ties included: an identity grid puts every point on an
integer coordinate and the first row and column on the border clamp.
"""

import torch
from torch.autograd.function import once_differentiable

from gangealing_torch import _build


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


def grid_sample_auto(input, grid, mode="bilinear", padding_mode="border",
                     align_corners=False):
    """grid_sample through the CUDA kernels where they exist.

    A CPU tensor takes the plain ``grid_sample``. A CUDA tensor in bilinear
    mode with ``align_corners=False`` goes through ``GridSample``, whose
    forward and backward launch the kernels or raise. K2 reads an input
    that is contiguous or channels_last as it lies; any other layout is
    copied to a contiguous one first. Nearest mode and
    ``align_corners=True`` were never in a TPU kernel and stay plain PyTorch
    on CUDA too.
    """
    if input.device.type == "cpu" or mode != "bilinear" or align_corners:
        return grid_sample(input, grid, mode=mode, padding_mode=padding_mode,
                           align_corners=align_corners)
    if not (input.is_contiguous()
            or input.is_contiguous(memory_format=torch.channels_last)):
        input = input.contiguous()
    return GridSample.apply(input, grid.contiguous(), padding_mode)


class GridSample(torch.autograd.Function):
    """Bilinear, align_corners=False grid_sample on the card: K2 forward;
    the backward launches K4 for d/dgrid (on a contiguous copy of a
    channels_last input) and K5b for d/dinput (written as NCHW), each only
    when that input needs a gradient."""

    @staticmethod
    def forward(ctx, input, grid, padding_mode):
        ctx.save_for_backward(input, grid)
        ctx.padding_mode = padding_mode
        return grid_sample_cuda(input, grid, padding_mode)

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        input, grid = ctx.saved_tensors
        dout = dout.contiguous()
        dinput = dgrid = None
        if ctx.needs_input_grad[1]:
            dgrid = grid_sample_dgrid(input.contiguous(), grid, dout,
                                      ctx.padding_mode)
        if ctx.needs_input_grad[0]:
            dinput = grid_sample_dimg(grid, dout, input.shape,
                                      ctx.padding_mode)
        return dinput, dgrid, None


def _check_grid(grid, N):
    _, Ho, Wo, two = grid.shape
    if grid.shape[0] != N or two != 2:
        raise ValueError(f"grid must be ({N}, Ho, Wo, 2), got {tuple(grid.shape)}")
    return Ho, Wo


def _check_dout(dout, N, C, Ho, Wo, device):
    _build.check_operand("dout", dout, 4, device)
    if tuple(dout.shape) != (N, C, Ho, Wo):
        raise ValueError(f"dout must be {(N, C, Ho, Wo)}, got {tuple(dout.shape)}")


def grid_sample_cuda(input, grid, padding_mode="border"):
    """K2: bilinear, align_corners=False grid_sample on the card.

    input (N, C, H, W) float32, contiguous or channels_last, and grid
    (N, Ho, Wo, 2) contiguous float32, CUDA tensors on one device. Returns
    (N, C, Ho, Wo) float32.
    """
    device = input.device
    _build.check_operand("input", input, 4, device, channels_last=True)
    _build.check_operand("grid", grid, 4, device)
    N, C, H, W = input.shape
    Ho, Wo = _check_grid(grid, N)
    code = _build.padding_code(padding_mode)
    out = torch.empty((N, C, Ho, Wo), device=device, dtype=torch.float32)
    lib = _build.load_kernels()
    _build.launch("grid_sample", lib.gg_grid_sample_fwd, input.data_ptr(),
                  grid.data_ptr(), out.data_ptr(), N, C, H, W, Ho * Wo, Wo,
                  int(not input.is_contiguous()), code, device.index,
                  _build.stream_of(device))
    return out


def grid_sample_dgrid(input, grid, dout, padding_mode="border"):
    """K4: the gradient of ``grid_sample_cuda`` with respect to the grid,
    (N, Ho, Wo, 2), given ``dout`` (N, C, Ho, Wo) on the card."""
    device = input.device
    _build.check_operand("input", input, 4, device)
    _build.check_operand("grid", grid, 4, device)
    N, C, H, W = input.shape
    Ho, Wo = _check_grid(grid, N)
    _check_dout(dout, N, C, Ho, Wo, device)
    code = _build.padding_code(padding_mode)
    dgrid = torch.empty_like(grid)
    lib = _build.load_kernels()
    _build.launch("grid_sample_dgrid", lib.gg_grid_sample_dgrid,
                  input.data_ptr(), grid.data_ptr(), dout.data_ptr(),
                  dgrid.data_ptr(), N, C, H, W, Ho * Wo, code, device.index,
                  _build.stream_of(device))
    return dgrid


def grid_sample_dimg(grid, dout, input_shape, padding_mode="border"):
    """K5b: the gradient of ``grid_sample_cuda`` with respect to its input,
    of ``input_shape`` (N, C, H, W), NCHW, given ``dout`` on the card. A
    binned gather with no atomics: the same bits from run to run. Three
    kernels, one count in ``LAUNCHES``; d/dimage and the scratch come from
    ``torch.empty``."""
    device = grid.device
    _build.check_operand("grid", grid, 4, device)
    N, C, H, W = input_shape
    Ho, Wo = _check_grid(grid, N)
    _check_dout(dout, N, C, Ho, Wo, device)
    code = _build.padding_code(padding_mode)
    if Ho * Wo == 0:
        return torch.zeros((N, C, H, W), device=device, dtype=torch.float32)
    if grid.data_ptr() % 8:  # K5b reads a point as one float2
        grid = grid.clone()
    lib = _build.load_kernels()
    nbytes = lib.gg_grid_sample_dimg_scratch(N, C, H, W, Ho * Wo)
    if nbytes < 0:
        raise ValueError(f"K5b does not take an image of {input_shape} "
                         f"sampled at {Ho} x {Wo} points")
    dimg = torch.empty((N, C, H, W), device=device, dtype=torch.float32)
    scratch = torch.empty(max(nbytes, 1), device=device, dtype=torch.uint8)
    _build.launch("grid_sample_dimg", lib.gg_grid_sample_dimg,
                  grid.data_ptr(), dout.data_ptr(), dimg.data_ptr(),
                  scratch.data_ptr(), N, C, H, W, Ho * Wo, code, device.index,
                  _build.stream_of(device))
    return dimg


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
