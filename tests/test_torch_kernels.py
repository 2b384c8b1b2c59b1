"""The port's CUDA kernels and their wrappers.

On the CPU: the port imports no JAX; the wrappers take their plain versions
for CPU tensors, launch nothing and refuse to pass a CPU tensor to a kernel;
and the plain versions match the TPU kernels they stand for, run in
interpret mode as the JAX package's own tests run them (atol 1e-5, f32).

On the card (marker ``cuda``, skipped without one): each forward kernel
against its plain version on the same CUDA tensors (atol 1e-5), each
backward kernel against the plain version's autograd (atol 1e-5 scaled by
max(1, max|ref|): K5a and K5b gather each texel's sum in a fixed order,
the same from run to run but not the CPU's), three launches of K5a equal
to the bit, K5a and K5b on images of 256 and 512 px, the launch counts,
and the FIR kernel (csrc/upfirdn2d.cu) at the cells' call shapes, its
gradient and gradient of gradient against the plain version in float64
and the JAX package's upfirdn2d and its VJP on the CPU (1e-5 scaled), in
bfloat16, float16 and float64 against ATen's depthwise conv in that dtype
(a unit in the last place), one launch a call, and no depthwise conv wider
than 3 channels in a congeal forward (float32 and bfloat16) or a train
step:

    python -m pytest -p no:cacheprovider -m cuda tests/test_torch_kernels.py
"""

import dataclasses
import re
import subprocess
import sys
from importlib import import_module
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from torch.utils._python_dispatch import TorchDispatchMode

from gangealing_torch import LAUNCHES
from gangealing_torch.models import latent_learner, layers, lpips, stn
from gangealing_torch.models import stylegan2
from gangealing_torch.models.layers import BLUR_KERNEL
from gangealing_torch.ops import grid_sample as tgs
from gangealing_torch.ops import mipmap as tmm
from gangealing_torch.ops import resample
from gangealing_torch.train import state

jmm = import_module("gangealing_tpu.ops.mipmap")
jpgs = import_module("gangealing_tpu.ops.pallas_grid_sample")
jrs = import_module("gangealing_tpu.ops.resample")

PADDINGS = ["border", "reflection", "zeros"]
REPO = Path(__file__).resolve().parent.parent


def _inputs(seed, N=2, C=3, H=32, out=16):
    """Image plus an affine grid from a zoom-in to a zoom-out by 6 with
    rotation, reaching outside the image, with levels spanning [0, 2.5]."""
    rng = np.random.RandomState(seed)
    img = rng.randn(N, C, H, H).astype(np.float32)
    s = np.geomspace(0.4, 6.0, N)
    a = rng.uniform(-np.pi, np.pi, N)
    th = np.stack([np.stack([s * np.cos(a), -s * np.sin(a), 0.2 + 0 * s], 1),
                   np.stack([s * np.sin(a), s * np.cos(a), -0.1 + 0 * s], 1)],
                  1).astype(np.float32)
    grid = tgs.affine_grid(torch.from_numpy(th), (N, C, out, out)).numpy()
    return img, grid


def test_port_imports_no_jax():
    """Every module of the port imports without loading JAX or any module
    of the JAX package, and so do load_stn (here on a path that does not
    exist, which it reports as such) and the CLIs' parsing of their
    flags: every CLI that runs the model defaults to the card."""
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).replace(
            ".__init__", "")
        for p in (REPO / "gangealing_torch").rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "from gangealing_torch.apps.common import load_stn\n"
            "try:\n"
            "    load_stn('no/such/stn.pt', device='cpu')\n"
            "    raise SystemExit('load_stn loaded a missing file')\n"
            "except FileNotFoundError as e:\n"
            "    assert 'no/such/stn.pt' in str(e), e\n"
            "from gangealing_torch.cli.train import training_argparse\n"
            "a = training_argparse().parse_args(\n"
            "    ['--exp-name', 'x', '--ckpt', 'g.pt', '--batch', '40'])\n"
            "assert a.batch == 40 and a.device == 'cuda'\n"
            "from gangealing_torch.cli.mixed_reality import "
            "mixed_reality_argparse\n"
            "a = mixed_reality_argparse().parse_args(\n"
            "    ['--ckpt', 'g.pt', '--video_path', 'v.mp4'])\n"
            "assert a.batch == 50 and a.device == 'cuda'\n"
            "from gangealing_torch.cli import (congeal_dataset, "
            "flow_scores, pck, prepare_data, propagate_to_images)\n"
            "for parser, extra in (\n"
            "        (pck.pck_argparse(), []),\n"
            "        (flow_scores.flow_scores_argparse(), []),\n"
            "        (congeal_dataset.congeal_dataset_argparse(),\n"
            "         ['--out', 'o']),\n"
            "        (propagate_to_images.propagate_to_images_argparse(),\n"
            "         [])):\n"
            "    a = parser.parse_args(['--ckpt', 'g.pt'] + extra)\n"
            "    assert a.batch == 50 and a.device == 'cuda'\n"
            "a = prepare_data.prepare_data_argparse().parse_args(\n"
            "    ['--out', 'o', '--path', 'p'])\n"
            "assert a.size == '256' and not hasattr(a, 'device')\n"
            "from gangealing_torch.cli import (process_video, "
            "vis_correspondence)\n"
            "a = vis_correspondence.vis_correspondence_argparse()"
            ".parse_args(\n"
            "    ['--ckpt', 'g.pt'])\n"
            "assert a.mode == 'track' and a.device == 'cuda'\n"
            "a = process_video.process_video_argparse().parse_args(\n"
            "    ['--video', 'v.mp4', '--out', 'o'])\n"
            "assert a.size == '256' and not hasattr(a, 'device')\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib', 'gangealing_tpu')))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert len(modules) >= 57
    assert {"gangealing_torch.train.synthetic",
            "gangealing_torch.models.lpips_backbones",
            "gangealing_torch.data.native_loader"} <= set(modules)


def test_port_sources_import_nothing_of_jax():
    """No line of the port's modules (the multi-process runtime
    gangealing_torch/parallel among them) or of the card scripts
    (chip_smoke.py, the variants scripts, chip_cars_batch.py,
    chip_serve_rates.py, chip_bf16_noise.py, chip_dist_determinism.py,
    chip_loader.py)
    imports jax or the JAX package, at top level or inside a
    function."""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|gangealing_tpu)"
                         r"\b")
    files = sorted((REPO / "gangealing_torch").rglob("*.py"))
    assert {"mesh.py", "launch.py"} <= {
        f.name for f in files if f.parent.name == "parallel"}
    chips = sorted(REPO.glob("chip_*.py"))
    assert len(chips) >= 6 and "chip_loader.py" in {f.name for f in chips}
    assert "native_loader.py" in {f.name for f in files}
    files += chips
    bad = [f"{f.relative_to(REPO)}:{i}: {line.strip()}"
           for f in files
           for i, line in enumerate(f.read_text().splitlines(), 1)
           if pattern.match(line)]
    assert not bad, bad


@pytest.mark.parametrize("padding_mode", PADDINGS)
def test_wrappers_take_plain_version_on_cpu(padding_mode):
    img, grid = _inputs(0)
    x, g = torch.from_numpy(img), torch.from_numpy(grid)
    before = dict(LAUNCHES)
    out = tgs.grid_sample_auto(x, g, padding_mode=padding_mode)
    assert torch.equal(out, tgs.grid_sample(x, g, padding_mode=padding_mode))
    out = tmm.mipmap_warp(x, g, padding_mode=padding_mode)
    levels = tmm.mipmap_levels(g, 32, 32, 3.5)
    ref = tmm._mipmap_warp_fold(x, g, 4, levels, padding_mode)
    assert torch.equal(out, ref)
    assert LAUNCHES == before


def test_kernel_entry_points_refuse_cpu_tensors():
    img, grid = _inputs(0)
    x, g = torch.from_numpy(img), torch.from_numpy(grid)
    before = dict(LAUNCHES)
    with pytest.raises(ValueError, match="must be on"):
        tgs.grid_sample_cuda(x, g)
    with pytest.raises(ValueError, match="must be on"):
        tmm.mipmap_sample(tmm._build_pyramid(x, 4), g, g[..., 0].contiguous())
    with pytest.raises(ValueError, match="must be on"):
        tmm.mipmap_sample_dpyramid(tmm._build_pyramid(x, 4).shape, g,
                                   g[..., 0].contiguous(),
                                   torch.zeros(2, 3, 16, 16))
    with pytest.raises(ValueError, match="must be on"):
        resample.upfirdn2d_cuda(x, resample.fir(BLUR_KERNEL), 1, 1,
                                (2, 2, 2, 2))
    assert LAUNCHES == before


@pytest.mark.parametrize("padding_mode", PADDINGS)
def test_plain_mipmap_matches_tpu_kernel_interpret(padding_mode):
    """Plain mipmap_warp == the banded Pallas kernel (K1) in interpret mode."""
    img, grid = _inputs(1)
    levels = jmm.mipmap_levels(jnp.asarray(grid), 32, 32, 3.5)
    ref = jmm._mipmap_warp_banded(jnp.asarray(img), jnp.asarray(grid), 4,
                                  levels, padding_mode, precision="f32",
                                  interpret=True)
    out = tmm.mipmap_warp(torch.from_numpy(img), torch.from_numpy(grid),
                          padding_mode=padding_mode)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("padding_mode", PADDINGS)
def test_plain_grid_sample_matches_tpu_kernel_interpret(padding_mode):
    """Plain grid_sample == the Pallas grid-sample kernel (K2) in interpret
    mode."""
    img, grid = _inputs(2)
    ref = jpgs.grid_sample_mxu(jnp.asarray(img), jnp.asarray(grid),
                               padding_mode=padding_mode, precision="f32",
                               point_block=128, interpret=True)
    out = tgs.grid_sample(torch.from_numpy(img), torch.from_numpy(grid),
                          padding_mode=padding_mode)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("padding_mode", PADDINGS)
def test_grid_sample_kernel_matches_plain(cuda, padding_mode):
    img, grid = _inputs(3, N=3, C=5, H=40, out=24)
    x, g = torch.from_numpy(img).to(cuda), torch.from_numpy(grid).to(cuda)
    before = LAUNCHES["grid_sample"]
    out = tgs.grid_sample_auto(x, g, padding_mode=padding_mode)
    torch.cuda.synchronize()
    assert LAUNCHES["grid_sample"] == before + 1
    ref = tgs.grid_sample(x, g, padding_mode=padding_mode)
    assert float((out - ref).abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("size", [64, 48])
@pytest.mark.parametrize("padding_mode", PADDINGS)
def test_mipmap_kernel_matches_plain(cuda, padding_mode, size):
    """K1 through mipmap_warp against the fold path, at a power-of-2 size
    and at one the pyramid reflect-pads, with an output that is no multiple
    of the kernel's 32 x 4 tile, at 5 channels and at 3."""
    img, grid = _inputs(4, N=3, C=5, H=size, out=35)
    x, g = torch.from_numpy(img).to(cuda), torch.from_numpy(grid).to(cuda)
    levels = tmm.mipmap_levels(g, size, size, 3.5)
    for c in (5, 3):  # any channel count, and the kernel's unrolled form
        xc = x[:, :c].contiguous()
        before = LAUNCHES["mipmap_sample"]
        out = tmm.mipmap_warp(xc, g, padding_mode=padding_mode)
        torch.cuda.synchronize()
        assert LAUNCHES["mipmap_sample"] == before + 1
        ref = tmm._mipmap_warp_fold(xc, g, 4, levels, padding_mode)
        assert float((out - ref).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_kernel_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(1, 3, 8, 8, device=cuda)
    g = torch.zeros(1, 4, 4, 2, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        tgs.grid_sample_cuda(x.double(), g)
    with pytest.raises(ValueError, match="contiguous"):
        tgs.grid_sample_cuda(x, g.transpose(1, 2))
    with pytest.raises(ValueError, match="padding_mode"):
        tgs.grid_sample_cuda(x, g, "wrap")
    levels = torch.zeros(1, 4, 4, device=cuda)
    one_level = tmm.Pyramid(x, torch.zeros(1, 0, device=cuda),
                            tmm.PyramidShape(1, 3, 8, 8, 8, 0))
    with pytest.raises(ValueError, match="2 levels"):
        tmm.mipmap_sample(one_level, g, levels)
    pyramid = tmm._build_pyramid(x, 3)
    with pytest.raises(ValueError, match="a pyramid of"):
        tmm.mipmap_sample(pyramid._replace(coarse=pyramid.coarse[:, 4:]),
                          g, levels)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tmm.mipmap_sample(pyramid._replace(
            coarse=torch.zeros(1, pyramid.coarse.shape[1] + 1,
                               device=cuda)[:, 1:]), g, levels)
    f = resample.fir(BLUR_KERNEL)
    with pytest.raises(ValueError, match="bfloat16"):
        resample.upfirdn2d_cuda(x.int(), f, 1, 1, (2, 2, 2, 2))
    with pytest.raises(ValueError, match="taps"):
        resample.upfirdn2d_cuda(x, resample.fir((1, 2, 3, 2, 1)), 1, 1,
                                (2, 2, 2, 2))


def _grad_inputs(seed, cuda, N, C, H, out, kind):
    """The identity grid at the source's size (integer coordinates, the
    border clamp) or the affine zoom of ``_inputs``, with a cotangent."""
    if kind == "identity":
        out = H
    img, grid = _inputs(seed, N=N, C=C, H=H, out=out)
    if kind == "identity":
        grid = tgs.identity_grid(N, out, out).numpy()
    cot = np.random.RandomState(seed + 100).randn(N, C, out, out)
    return (torch.from_numpy(img).to(cuda), torch.from_numpy(grid).to(cuda),
            torch.from_numpy(cot.astype(np.float32)).to(cuda))


def _scaled_err(ours, ref):
    return float((ours - ref).abs().max()) / max(1.0, float(ref.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["identity", "affine"])
@pytest.mark.parametrize("padding_mode", PADDINGS)
def test_grid_sample_backward_kernels_match_plain(cuda, padding_mode, kind):
    """K4 (d/dgrid) and K5b (d/dimage) against the plain autograd."""
    x, g, cot = _grad_inputs(5, cuda, 3, 5, 40, 24, kind)
    ref = torch.autograd.grad(
        tgs.grid_sample(x.requires_grad_(), g.requires_grad_(),
                        padding_mode=padding_mode), (x, g), cot)
    before = dict(LAUNCHES)
    out = tgs.grid_sample_auto(x, g, padding_mode=padding_mode)
    ours = torch.autograd.grad(out, (x, g), cot)
    torch.cuda.synchronize()
    assert LAUNCHES["grid_sample_dgrid"] == before["grid_sample_dgrid"] + 1
    assert LAUNCHES["grid_sample_dimg"] == before["grid_sample_dimg"] + 1
    for o, r in zip(ours, ref):
        assert _scaled_err(o, r) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["identity", "affine"])
@pytest.mark.parametrize("padding_mode", PADDINGS)
def test_mipmap_backward_kernels_match_plain(cuda, padding_mode, kind):
    """K3 (d/dgrid, d/dlevels) and K5a (d/dlevel0, d/dcoarse) against the
    plain autograd of
    _sample_pyramid, at the warp's levels, at integer ones and one float
    step below them (where |level - (f + 2)| rounds to the tent's kink),
    with 5 channels and with 3 (the kernels' unrolled form)."""
    x, g, cot = _grad_inputs(6, cuda, 3, 5, 64, 32, kind)
    level0, coarse, shape = tmm._build_pyramid(x, 4)
    levels = tmm.mipmap_levels(g, 64, 64, 3.5)
    whole = torch.round(levels * 1.2)
    below = torch.nextafter(whole, torch.full_like(whole, -1.0)).clamp(min=0)
    for lv in (levels, whole, below):
        lv = lv.contiguous()
        args = (level0.requires_grad_(), coarse.requires_grad_(),
                g.requires_grad_(), lv.requires_grad_())
        ref = torch.autograd.grad(
            tmm._sample_pyramid(tmm.Pyramid(*args[:2], shape), *args[2:],
                                padding_mode), args, cot)
        before = dict(LAUNCHES)
        ours = torch.autograd.grad(
            tmm.MipmapSample.apply(*args[:2], shape, *args[2:], padding_mode),
            args, cot)
        torch.cuda.synchronize()
        assert (LAUNCHES["mipmap_sample_dcoords"]
                == before["mipmap_sample_dcoords"] + 1)
        assert (LAUNCHES["mipmap_sample_dpyramid"]
                == before["mipmap_sample_dpyramid"] + 1)
        for o, r in zip(ours, ref):
            assert _scaled_err(o, r) <= 1e-5
        three = tmm._build_pyramid(x[:, :3].contiguous(), 4)
        gl = (g.detach().requires_grad_(), lv.detach().requires_grad_())
        ref = torch.autograd.grad(
            tmm._sample_pyramid(three, *gl, padding_mode), gl, cot[:, :3])
        ours = tmm.mipmap_sample_dcoords(three, *(t.detach() for t in gl),
                                         cot[:, :3].contiguous(),
                                         padding_mode)
        for o, r in zip(ours, ref):
            assert _scaled_err(o, r) <= 1e-5


@pytest.mark.cuda
def test_backward_launches_only_what_is_needed(cuda):
    """An image that needs no gradient launches no image-gradient kernel,
    and the perceptual-style loss reaches the grid through the kernels."""
    x, g, cot = _grad_inputs(7, cuda, 2, 3, 64, 32, "affine")
    g.requires_grad_()
    before = dict(LAUNCHES)
    (tmm.mipmap_warp(x, g) * cot).sum().backward()
    (tgs.grid_sample_auto(x, g) * cot).sum().backward()
    torch.cuda.synchronize()
    assert LAUNCHES["mipmap_sample_dcoords"] == before["mipmap_sample_dcoords"] + 1
    assert LAUNCHES["grid_sample_dgrid"] == before["grid_sample_dgrid"] + 1
    assert (LAUNCHES["mipmap_sample_dpyramid"]
            == before["mipmap_sample_dpyramid"])
    assert LAUNCHES["grid_sample_dimg"] == before["grid_sample_dimg"]
    assert float(g.grad.abs().sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("padding_mode", PADDINGS)
def test_mipmap_warp_image_grad_matches_fold(cuda, padding_mode):
    """d/dimage of the whole warp on the card (K5a and the blur chain)
    against the fold path's autograd, at a size the pyramid reflect-pads."""
    x, g, cot = _grad_inputs(8, cuda, 2, 3, 48, 24, "affine")
    x.requires_grad_()
    ours = torch.autograd.grad(tmm.mipmap_warp(x, g, padding_mode=padding_mode),
                               x, cot)[0]
    levels = tmm.jmax(tmm.mipmap_levels(g, 48, 48, 3.5), 0.0)
    ref = torch.autograd.grad(
        tmm._mipmap_warp_fold(x, g, 4, levels, padding_mode), x, cot)[0]
    assert _scaled_err(ours, ref) <= 1e-5


def _k5a_case(cuda, kind, N, C, size, out, seed):
    """A pyramid's shape, a grid of ``kind`` (identity, affine, or the
    skewed zoom-in and border pile of chip_smoke.SKEWED: scale 0.25 and 2)
    at ``out`` x ``out`` points, its warp levels and a cotangent."""
    if kind == "affine":
        _, grid = _inputs(seed, N=N, C=C, H=size, out=out)
        grid = torch.from_numpy(grid)
    elif kind == "identity":
        grid = tgs.identity_grid(N, out, out)
    else:
        th = torch.zeros(N, 2, 3)
        th[:, 0, 0] = th[:, 1, 1] = {"zoom": 0.25, "pile": 2.0}[kind]
        th[:, :, 2] = torch.from_numpy(
            np.random.RandomState(seed).uniform(-0.1, 0.1, (N, 2)))
        grid = tgs.affine_grid(th, (N, 1, out, out))
    grid = grid.contiguous().to(cuda)
    levels = tmm.jmax(tmm.mipmap_levels(grid, size, size, 3.5), 0.0)
    shape = tmm._build_pyramid(torch.zeros(1, C, size, size), 4).shape
    cot = torch.randn(N, C, out, out, device=cuda,
                      generator=torch.Generator(cuda).manual_seed(seed))
    return shape, grid, levels.contiguous(), cot


def _k5a_plain(shape, grid, levels, cot, padding_mode):
    N, dev = grid.shape[0], grid.device
    level0 = torch.zeros(N, shape.channels, shape.size, shape.size,
                         device=dev, requires_grad=True)
    coarse = torch.zeros(N, tmm._coarse_floats(shape), device=dev,
                         requires_grad=True)
    out = tmm._sample_pyramid(tmm.Pyramid(level0, coarse, shape), grid,
                              levels, padding_mode)
    return torch.autograd.grad(out, (level0, coarse), cot)


def _padding_lanes(shape, dcoarse):
    """d/dcoarse's padding channels, level by level."""
    t, C = shape.texel(), shape.channels
    parts = dcoarse.split([t * s * s for s in shape.sides()[1:]], dim=1)
    return torch.cat([p.reshape(p.shape[0], -1, t)[..., C:].reshape(-1)
                      for p in parts])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["identity", "zoom", "pile"])
@pytest.mark.parametrize("padding_mode", PADDINGS)
def test_k5a_matches_plain_and_repeats_its_bits(cuda, padding_mode, kind):
    """K5a on the identity and the skewed grids, from a 48 px image (the
    pyramid reflect-pads it to 64): within 1e-5 scaled of the plain
    autograd, three launches equal to the bit, one count a call, every
    texel that no point reaches and every padding channel exactly 0
    although the memory held NaN. The zoom-in puts each image's 4,096
    points into a twelfth of the image, so its tiles are split over many
    work items."""
    shape, grid, levels, cot = _k5a_case(cuda, kind, 2, 3, 48, 64, 9)
    ref = _k5a_plain(shape, grid, levels, cot, padding_mode)
    runs = []
    for _ in range(3):
        torch.full((4, 1 << 20), float("nan"), device=cuda)  # freed at once
        before = LAUNCHES["mipmap_sample_dpyramid"]
        runs.append(tmm.mipmap_sample_dpyramid(shape, grid, levels, cot,
                                               padding_mode))
        torch.cuda.synchronize()
        assert LAUNCHES["mipmap_sample_dpyramid"] == before + 1
    # the texels some point reaches: all weights are >= 0
    reach = _k5a_plain(shape, grid, levels, torch.ones_like(cot),
                       padding_mode)
    for o, r, hit in zip(runs[0], ref, reach):
        assert _scaled_err(o, r) <= 1e-5
        assert bool(torch.isfinite(o).all())
        assert bool((o[hit == 0] == 0).all())
    assert all(torch.equal(a, b) for r in runs[1:] for a, b in zip(runs[0], r))
    assert bool((_padding_lanes(shape, runs[0][1]) == 0).all())
    if kind == "zoom":
        assert int((reach[0] == 0).sum()) > reach[0].numel() // 2


@pytest.mark.cuda
@pytest.mark.parametrize("C", [3, 5])
@pytest.mark.parametrize("padding_mode", PADDINGS)
def test_k5a_channel_counts(cuda, padding_mode, C):
    """K5a at 3 channels (one float4 group) and 5 (two, the second mostly
    padding) on the affine grid, within 1e-5 scaled of the plain autograd,
    its padding channels 0."""
    shape, grid, levels, cot = _k5a_case(cuda, "affine", 3, C, 64, 40, 10)
    ours = tmm.mipmap_sample_dpyramid(shape, grid, levels, cot, padding_mode)
    for o, r in zip(ours, _k5a_plain(shape, grid, levels, cot,
                                     padding_mode)):
        assert _scaled_err(o, r) <= 1e-5
    assert bool((_padding_lanes(shape, ours[1]) == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("size", [256, 512])
@pytest.mark.parametrize("kind", ["affine", "zoom"])
def test_k5a_and_k5b_take_large_images(cuda, kind, size):
    """K5a on a pyramid of a 256 and a 512 px image (1,360 and 5,440 tiles
    of 16 x 4 texels: more keys than one bin pass counts at 512) and K5b on
    the image itself (4,096 tiles at 512 px, which its bin refused before
    it counted in passes), each within 1e-5 scaled of the plain autograd,
    K5a twice equal to the bit."""
    shape, grid, levels, cot = _k5a_case(cuda, kind, 2, 3, size, 128, 11)
    ref = _k5a_plain(shape, grid, levels, cot, "border")
    runs = [tmm.mipmap_sample_dpyramid(shape, grid, levels, cot, "border")
            for _ in range(2)]
    for o, r in zip(runs[0], ref):
        assert _scaled_err(o, r) <= 1e-5
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    x = torch.zeros(2, 3, size, size, device=cuda, requires_grad=True)
    ref = torch.autograd.grad(tgs.grid_sample(x, grid), x, cot)[0]
    ours = tgs.grid_sample_dimg(grid, cot, tuple(x.shape))
    assert _scaled_err(ours, ref) <= 1e-5


# The FIR kernel (csrc/upfirdn2d.cu) at the call shapes of the benchmark's
# cells: (taps' gain, up, down, pad, channels, side). The STN encoders'
# Blur (pad (2, 2) in a ResBlock's conv path, (1, 1) in its skip) from 128
# px at 64 channels down to 8 px at 512; G's blur after each transposed
# conv (gain 4, pad (1, 1), odd sides 9 to 257 at its 512 to 128
# channels); ToRGB's upsample2x (up 2, 3 channels) and its gradient (down 2).
FIR_CALLS = {
    "stn_128_64": (1, 1, 1, (2, 2), 64, 128),
    "stn_skip_128_64": (1, 1, 1, (1, 1), 64, 128),
    "stn_64_128": (1, 1, 1, (2, 2), 128, 64),
    "stn_32_512": (1, 1, 1, (2, 2), 512, 32),
    "stn_16_512": (1, 1, 1, (2, 2), 512, 16),
    "stn_skip_8_512": (1, 1, 1, (1, 1), 512, 8),
    "g_9_512": (4, 1, 1, (1, 1), 512, 9),
    "g_65_512": (4, 1, 1, (1, 1), 512, 65),
    "g_129_256": (4, 1, 1, (1, 1), 256, 129),
    "g_257_128": (4, 1, 1, (1, 1), 128, 257),
    "upsample2x_128": (4, 2, 1, (2, 1), 3, 128),
    "upsample2x_4": (4, 2, 1, (2, 1), 3, 4),
    "upsample2x_grad_256": (4, 1, 2, (1, 1), 3, 256),
}
FIR_BACKWARD = ("stn_32_512", "g_129_256", "stn_skip_8_512", "upsample2x_128")


# the cases of the FIR kernel in bfloat16, float16 and float64
FIR_DTYPE_CALLS = ("stn_128_64", "stn_skip_8_512", "g_65_512",
                   "upsample2x_128", "upsample2x_grad_256")


def _fir_case(cuda, call, seed=13):
    gain, up, down, pad, C, side = FIR_CALLS[call]
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, C, side, side, generator=g)
    return resample.fir(BLUR_KERNEL, gain), up, down, pad, x


def _pads(pad):
    return (pad[0], pad[1], pad[0], pad[1])


def _fir_plain(f, up, down, pad, x):
    """The plain version in float64 on the CPU."""
    return resample.upfirdn2d_plain(x.double().cpu(),
                                    resample.fir_matrix(f).double(), up, down,
                                    _pads(pad))


def _fir_card_plain(f, up, down, pad, x):
    """The plain version on the card: F.pad and ATen's depthwise conv."""
    return resample.upfirdn2d_plain(x, resample.fir_matrix(f).to(x.device),
                                    up, down, _pads(pad))


def _fir_jax(f, up, down, pad, x, dy=None):
    """The JAX package's upfirdn2d of the CPU tensor ``x`` on the CPU, or,
    given ``dy``, its VJP: the gradient with respect to ``x``."""
    k = jrs.make_kernel(f.k) * f.gain

    def fn(t):
        return jrs.upfirdn2d(t, k, up=up, down=down, pad=pad)
    if dy is None:
        return torch.from_numpy(np.array(fn(jnp.asarray(x.detach().numpy()))))
    _, vjp = jax.vjp(fn, jnp.asarray(x.detach().numpy()))
    (dx,) = vjp(jnp.asarray(dy.detach().numpy()))
    return torch.from_numpy(np.array(dx))


@pytest.mark.cuda
@pytest.mark.parametrize("call", sorted(FIR_CALLS))
def test_fir_kernel_matches_plain(cuda, call):
    """The kernel gives the bits of the plain version on the card, and is
    within 1e-5 (scaled) of the float64 function and of the JAX package's
    upfirdn2d."""
    f, up, down, pad, x = _fir_case(cuda, call)
    xc = x.to(cuda)
    before = dict(LAUNCHES)
    out = resample.upfirdn2d(xc, f, up=up, down=down, pad=pad)
    torch.cuda.synchronize()
    assert LAUNCHES["upfirdn2d"] == before["upfirdn2d"] + 1
    assert torch.equal(out, _fir_card_plain(f, up, down, pad, xc))
    assert _scaled_err(out.double().cpu(), _fir_plain(f, up, down, pad, x)) \
        <= 1e-5
    assert _scaled_err(out.cpu(), _fir_jax(f, up, down, pad, x)) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("call", FIR_BACKWARD)
def test_fir_backward_and_double_backward_match_plain(cuda, call):
    """The kernel's gradient against autograd of the plain version on the
    card (to the bit), in float64 and against the JAX package's VJP, and
    the gradient of that gradient with respect to the output's gradient,
    which is the forward again."""
    f, up, down, pad, x = _fir_case(cuda, call, 14)
    ref_x = x.double().requires_grad_()
    ref_y = _fir_plain(f, up, down, pad, ref_x)
    gen = torch.Generator().manual_seed(15)
    dy = torch.randn(ref_y.shape, generator=gen)
    w = torch.randn(x.shape, generator=gen)
    (ref_dx,) = torch.autograd.grad(ref_y, ref_x, dy.double())
    xc = x.to(cuda).requires_grad_()
    dyc = dy.to(cuda).requires_grad_()
    before = dict(LAUNCHES)
    y = resample.upfirdn2d(xc, f, up=up, down=down, pad=pad)
    (dx,) = torch.autograd.grad(y, xc, dyc, create_graph=True)
    (ddy,) = torch.autograd.grad(dx, dyc, w.to(cuda))
    torch.cuda.synchronize()
    plain_x = x.to(cuda).requires_grad_()
    (plain_dx,) = torch.autograd.grad(
        _fir_card_plain(f, up, down, pad, plain_x), plain_x, dy.to(cuda))
    assert torch.equal(dx.detach(), plain_dx)
    assert _scaled_err(dx.detach().double().cpu(), ref_dx) <= 1e-5
    assert _scaled_err(dx.detach().cpu(),
                       _fir_jax(f, up, down, pad, x, dy)) <= 1e-5
    assert _scaled_err(ddy.double().cpu(), _fir_plain(f, up, down, pad, w)) \
        <= 1e-5
    assert LAUNCHES["upfirdn2d"] == before["upfirdn2d"] + 1
    assert LAUNCHES["upfirdn2d_dx"] == before["upfirdn2d_dx"] + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float64])
@pytest.mark.parametrize("call", FIR_DTYPE_CALLS)
def test_fir_kernel_in_other_dtypes(cuda, call, dtype):
    """In bfloat16 and float16 (summed in float) the kernel's output and
    gradient are in the input's dtype and within a unit in the last place
    of ATen's depthwise conv and its autograd in that dtype, and within
    half a unit of the float64 function of the same inputs; in float64
    within 1e-12 (scaled) of both."""
    f, up, down, pad, x = _fir_case(cuda, call, 16)
    x = x.to(dtype)
    xc = x.to(cuda).requires_grad_()
    before = dict(LAUNCHES)
    y = resample.upfirdn2d(xc, f, up=up, down=down, pad=pad)
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(17))
    dy = dy.to(dtype)
    (dx,) = torch.autograd.grad(y, xc, dy.to(cuda))
    torch.cuda.synchronize()
    assert {k: LAUNCHES[k] - before[k] for k in LAUNCHES
            if LAUNCHES[k] != before[k]} == {"upfirdn2d": 1, "upfirdn2d_dx": 1}
    assert y.dtype == dx.dtype == dtype
    plain_x = x.to(cuda).requires_grad_()
    plain_y = _fir_card_plain(f, up, down, pad, plain_x)
    (plain_dx,) = torch.autograd.grad(plain_y, plain_x, dy.to(cuda))
    ref_x = x.double().requires_grad_()
    ref_y = _fir_plain(f, up, down, pad, ref_x)
    (ref_dx,) = torch.autograd.grad(ref_y, ref_x, dy.double())
    eps = torch.finfo(dtype).eps
    for ours, aten, exact in ((y, plain_y, ref_y), (dx, plain_dx, ref_dx)):
        ours = ours.detach().double().cpu()
        aten, exact = aten.detach().double().cpu(), exact.detach()
        scale = max(1.0, float(exact.abs().max()))
        if dtype == torch.float64:
            assert _scaled_err(ours, aten) <= 1e-12
            assert _scaled_err(ours, exact) <= 1e-12
            continue
        assert bool(((ours - aten).abs()
                     <= eps * aten.abs() + 1e-5 * scale).all())
        assert bool(((ours - exact).abs()
                     <= eps / 2 * exact.abs() + 1e-5 * scale).all())


@pytest.mark.cuda
def test_fir_launches_once_a_call(cuda):
    """One kernel launch a forward of each caller, one a backward; a
    bfloat16 tensor launches it too, and its output is bfloat16."""
    x = torch.randn(2, 8, 16, 16, device=cuda, requires_grad=True)
    blur_layer = layers.Blur(BLUR_KERNEL, pad=(2, 2))
    callers = {"Blur": blur_layer,
               "blur": lambda t: resample.blur(t, BLUR_KERNEL, (1, 1), 2),
               "upsample2x": lambda t: resample.upsample2x(t, BLUR_KERNEL)}
    for name, fn in callers.items():
        before = dict(LAUNCHES)
        y = fn(x)
        assert LAUNCHES["upfirdn2d"] - before["upfirdn2d"] == 1, name
        y.backward(torch.ones_like(y))
        torch.cuda.synchronize()
        after = {k: LAUNCHES[k] - before[k] for k in LAUNCHES
                 if LAUNCHES[k] != before[k]}
        assert after == {"upfirdn2d": 1, "upfirdn2d_dx": 1}, name
    before = dict(LAUNCHES)
    xb = x.detach().bfloat16()
    out = blur_layer(xb)
    assert out.dtype == torch.bfloat16
    assert LAUNCHES["upfirdn2d"] == before["upfirdn2d"] + 1
    ref = resample.upfirdn2d(xb.cpu(), blur_layer.fir, pad=(2, 2))
    assert _scaled_err(out.float().cpu(), ref.float()) <= 1e-2


class _GroupedConvs(TorchDispatchMode):
    """Records the channels of every grouped (depthwise) convolution and
    convolution backward dispatched under it."""

    def __init__(self):
        super().__init__()
        self.groups = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.convolution.default and args[8] > 1:
            self.groups.append(args[8])
        if func is torch.ops.aten.convolution_backward.default \
                and args[9] > 1:
            self.groups.append(args[9])
        return func(*args, **(kwargs or {}))


@pytest.mark.cuda
def test_congeal_and_train_step_run_no_wide_depthwise_conv(cuda,
                                                           monkeypatch):
    """A flagship congeal forward, in float32 and in bfloat16, and a train
    step at 512 channels run every FIR through the kernel, each on an
    NCHW-contiguous input as it comes (no copy): the only depthwise convs
    left are the 3-channel resamplers with reflection padding
    (bilinear_downsample and the pyramid's blur)."""
    strided = []
    card_path = resample.upfirdn2d_card

    def spy(x, *args):
        strided.append(not x.is_contiguous())
        return card_path(x, *args)
    monkeypatch.setattr(resample, "upfirdn2d_card", spy)
    gen = torch.Generator().manual_seed(0)
    t_cfg = stn.ComposedSTNConfig(transforms=("similarity", "flow"),
                                  flow_size=128, supersize=256,
                                  channel_multiplier=0.5)
    model = stn.ComposedSTN(t_cfg, device=cuda, generator=gen).eval()
    images = torch.rand(2, 3, 256, 256, generator=gen).to(cuda)
    before = dict(LAUNCHES)
    with torch.no_grad(), _GroupedConvs() as mode:
        model(images)
    assert set(mode.groups) <= {3}, mode.groups
    assert LAUNCHES["upfirdn2d"] > before["upfirdn2d"]
    bf16 = stn.ComposedSTN(dataclasses.replace(t_cfg,
                                               compute_dtype="bfloat16"),
                           device=cuda, generator=gen).eval()
    before = dict(LAUNCHES)
    with torch.no_grad(), _GroupedConvs() as mode:
        bf16(images)
    assert set(mode.groups) <= {3}, mode.groups
    assert LAUNCHES["upfirdn2d"] > before["upfirdn2d"]

    cfg = state.TrainConfig(
        g=stylegan2.GeneratorConfig(size=64, style_dim=64, n_mlp=2,
                                    channel_multiplier=2),
        t=stn.ComposedSTNConfig(transforms=("similarity", "flow"),
                                flow_size=64, supersize=64,
                                channel_multiplier=0.5, flow_downsample=4),
        ll=latent_learner.LatentLearnerConfig(n_comps=1, inject_index=5,
                                              n_latent=10, style_dim=64),
        batch=2, tv_weight=1000.0, flow_identity_weight=1.0, anneal_psi=100,
        period=50, loss_fn="vgg_ssl")
    generator = stylegan2.Generator(cfg.g, device=cuda, generator=gen)
    generator.requires_grad_(False)
    st = state.TrainState(
        cfg, stn.ComposedSTN(cfg.t, device=cuda, generator=gen),
        latent_learner.LatentLearner(cfg.ll, device=cuda, generator=gen))
    vgg = lpips.LPIPS(device=cuda, generator=gen).eval().requires_grad_(False)
    loss = lpips.make_perceptual_loss("vgg_ssl")
    z = torch.randn(2, 64, generator=gen).to(cuda)
    noise = tuple([torch.randn(s, generator=gen).to(cuda)
                   for s in cfg.g.noise_shapes(2)] for _ in range(2))
    before = dict(LAUNCHES)
    with _GroupedConvs() as mode:
        state.train_step(st, generator, lambda a, b: loss(vgg, a, b), z, 0.6,
                         1e-3, 1e-2, noise=noise)
        torch.cuda.synchronize()
    assert set(mode.groups) <= {3}, mode.groups
    assert LAUNCHES["upfirdn2d"] > before["upfirdn2d"]
    assert LAUNCHES["upfirdn2d_dx"] > before["upfirdn2d_dx"]
    assert strided and not any(strided)
