"""The port's AR apps (mixed_reality, propagate_to_images) and the
mixed-reality CLI against the JAX package's, on the CPU.

Same STN, images and label as tests/test_torch_ar.py. Tolerances: the
correspondences within 1e-3 px and the congealed frames within 5e-4, as
there; the propagated frames within 1e-3. Those frames splat points that
differ by up to about 1e-4 px, and a point's window edge (floor or ceil of
p -/+ 2 sigma) within that distance of an integer would move a whole
pixel in or out of the window. The points' differences alone move a
frame by about 1e-4 where the label's colors change fast: these seeded
inputs read up to 1.6e-4.
"""

import dataclasses
import os
from importlib import import_module

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gangealing_torch.apps import mixed_reality as tmr
from gangealing_torch.apps import propagate_to_images as tprop
from gangealing_torch.apps.common import load_stn
from gangealing_torch.cli import mixed_reality as tcli
from gangealing_torch.data import prepare as tprep
from gangealing_torch.models import stn as tstn

from test_torch_ar import (ARCH, ar_images, ar_model, ar_params,
                           label_png)

jstn = import_module("gangealing_tpu.models.stn")
jmr = import_module("gangealing_tpu.apps.mixed_reality")
jprop = import_module("gangealing_tpu.apps.propagate_to_images")
jprep = import_module("gangealing_tpu.data.prepare")

S = 64
JCFG = jstn.ComposedSTNConfig(**ARCH)
PT_TOL, OUT_TOL, PROP_TOL = 1e-3, 5e-4, 1e-3


@pytest.fixture(scope="module")
def params():
    return ar_params()


@pytest.fixture(scope="module")
def model(params):
    return ar_model(params)


def _close(ours, ref, atol):
    np.testing.assert_allclose(ours, np.asarray(ref), atol=atol, rtol=0)


def test_run_gangealing_on_video_matches_jax(tmp_path, params, model):
    """A label, flip inference on, correspondences saved, videos written;
    non-square frames, center-cropped."""
    label = label_png(tmp_path / "label.png")
    frames = np.concatenate([ar_images(12, 4)] * 2, axis=3)[..., 20:30 + S]
    kw = dict(label_path=label, batch=2, sigma=1.2,
              save_correspondences=True)
    ref = jmr.run_gangealing_on_video(
        {k: jnp.asarray(v) for k, v in params.items()}, JCFG, frames, **kw)
    ours = tmr.run_gangealing_on_video(model, frames,
                                       out_dir=str(tmp_path / "mr"), **kw)
    assert set(ours) == set(ref) == {"propagated", "congealed",
                                     "correspondences"}
    assert ours["propagated"].shape == (4, 3, S, S)
    _close(ours["correspondences"], ref["correspondences"], PT_TOL)
    _close(ours["congealed"], ref["congealed"], OUT_TOL)
    _close(ours["propagated"], ref["propagated"], PROP_TOL)
    for name in ("propagated.mp4", "congealed.mp4", "correspondences.pt"):
        assert os.path.getsize(tmp_path / "mr" / name) > 0
    saved = torch.load(tmp_path / "mr" / "correspondences.pt")
    np.testing.assert_array_equal(saved.numpy(), ours["correspondences"])


def test_run_gangealing_on_video_label_arrays_and_overlay(tmp_path, params,
                                                          model):
    """The label passed as arrays (the function's own arguments), the
    Laplacian blend and the label overlaid on the congealed frames."""
    from gangealing_torch.utils.vis import load_dense_label
    label = label_png(tmp_path / "label.png")
    pts, colors, alphas = load_dense_label(label, load_colors=True)
    frames = ar_images(13, 3)
    kw = dict(batch=2, blend_alg="laplacian_light", overlay_congealed=True,
              no_flip_inference=True)
    ref = jmr.run_gangealing_on_video(
        {k: jnp.asarray(v) for k, v in params.items()}, JCFG, frames,
        points=jnp.asarray(pts.numpy()), colors=jnp.asarray(colors.numpy()),
        alphas=jnp.asarray(alphas.numpy()), **kw)
    ours = tmr.run_gangealing_on_video(model, frames, points=pts,
                                       colors=colors, alphas=alphas, **kw)
    _close(ours["congealed"], ref["congealed"], PROP_TOL)
    _close(ours["propagated"], ref["propagated"], PROP_TOL)


def test_mixed_reality_save_frames_and_dir_input(tmp_path, model):
    """Frames from a directory, loaded a batch at a time, streamed to PNGs,
    mp4s assembled from the files; the frames equal those of the
    in-memory run within the PNGs' quantisation."""
    from PIL import Image
    label = label_png(tmp_path / "label.png")
    fdir = tmp_path / "framedir"
    fdir.mkdir()
    rng = np.random.RandomState(14)
    for i in (0, 1, 2, 10):
        Image.fromarray((rng.rand(S, S, 3) * 255).astype(np.uint8)).save(
            str(fdir / f"{i}.png"))
    paths = tprep.list_frame_paths(str(fdir))
    assert paths == jprep.list_frame_paths(str(fdir))
    assert [os.path.basename(p) for p in paths] == [
        "0.png", "1.png", "2.png", "10.png"]
    np.testing.assert_array_equal(tprep.load_frame_paths(paths),
                                  jprep.load_frame_paths(paths))
    np.testing.assert_array_equal(tprep.load_video_frames(str(fdir)),
                                  jprep.load_video_frames(str(fdir)))
    out_dir = str(tmp_path / "mr")
    streamed = tmr.run_gangealing_on_video(
        model, paths, label_path=label, batch=3, out_dir=out_dir,
        save_frames=True, fps=5)
    assert streamed == {}
    held = tmr.run_gangealing_on_video(
        model, tprep.load_frame_paths(paths), label_path=label, batch=3)
    for sub, key in (("frames", "propagated"),
                     ("congealing_frames", "congealed")):
        for i in range(4):
            png = np.asarray(Image.open(os.path.join(out_dir, sub,
                                                     f"{i}.png")))
            want = ((held[key][i] + 1) * 127.5).clip(0, 255).astype(np.uint8)
            assert np.abs(png.astype(int)
                          - want.transpose(1, 2, 0).astype(int)).max() <= 1
    for name in ("propagated.mp4", "congealed.mp4"):
        assert os.path.getsize(os.path.join(out_dir, name)) > 0


def test_nchw_center_crop_matches_jax():
    x = np.arange(2 * 3 * 5 * 8, dtype=np.float32).reshape(2, 3, 5, 8)
    ours, off = tprep.nchw_center_crop(x)
    ref, ref_off = jprep.nchw_center_crop(x)
    np.testing.assert_array_equal(ours, ref)
    assert off == ref_off


@pytest.mark.parametrize("objects", [True, False])
def test_propagate_to_images_matches_jax(tmp_path, params, model, objects):
    label = label_png(tmp_path / "label.png")
    imgs = ar_images(15, 5)
    kw = dict(label_path=label, batch=2, objects=objects)
    if not objects:
        kw.update(output_resolution=S // 2, average_n=2)
    ref = jprop.propagate_to_images(
        {k: jnp.asarray(v) for k, v in params.items()}, JCFG, imgs, **kw)
    ours = tprop.propagate_to_images(model, imgs,
                                     out_dir=str(tmp_path / "prop"), **kw)
    assert set(ours) == set(ref)
    for key in ("congealed", "average_congealed"):
        _close(ours[key], ref[key], OUT_TOL)
    _close(ours["propagated"], ref["propagated"], PROP_TOL)
    for name in ("congealed.png", "average_congealed.png", "propagated.png"):
        assert os.path.getsize(tmp_path / "prop" / name) > 0


def test_annotate_average_matches_jax(tmp_path):
    from PIL import Image
    label = label_png(tmp_path / "label.png")
    avg = tmp_path / "avg.png"
    Image.fromarray((np.random.RandomState(16).rand(48, 48, 3) * 255).astype(
        np.uint8)).save(str(avg))
    kw = dict(real_size=S, resolution=S, output_resolution=S // 2,
              objects=True)
    ref = jprop.annotate_average(str(avg), label, **kw)
    ours = tprop.annotate_average(str(avg), label,
                                  out_dir=str(tmp_path / "a"), **kw)
    _close(ours, ref, 1e-4)
    assert os.path.getsize(tmp_path / "a" / "average_annotated.png") > 0


def _checkpoint(tmp_path, model):
    import argparse
    path = tmp_path / "stn.pt"
    args = argparse.Namespace(transform=list(ARCH["transforms"]),
                              flow_size=S, stn_channel_multiplier=0.25,
                              num_heads=1, real_size=S, flow_downsample=4)
    torch.save({"t_ema": model.state_dict(), "args": args}, path)
    return str(path)


@pytest.fixture
def capped(monkeypatch):
    """The stored args carry no channel cap; this architecture has one."""
    import dataclasses
    from gangealing_torch.apps import common
    build = common.stn_config_from_args
    monkeypatch.setattr(common, "stn_config_from_args",
                        lambda a, supersize=None: dataclasses.replace(
                            build(a, supersize), max_channels=32))


def test_cli_mixed_reality_on_the_cpu(tmp_path, model, capped):
    """python -m gangealing_torch.cli.mixed_reality --device cpu on a
    frame directory: the run of run_gangealing_on_video on the same
    frames."""
    from PIL import Image
    ckpt = _checkpoint(tmp_path, model)
    label = label_png(tmp_path / "label.png")
    fdir = tmp_path / "frames"
    fdir.mkdir()
    frames = ar_images(17, 3)
    for i, f in enumerate(frames):
        Image.fromarray(((f + 1) * 127.5).round().astype(np.uint8).transpose(
            1, 2, 0)).save(str(fdir / f"{i}.png"))
    out = str(tmp_path / "out")
    got = tcli.main(["--ckpt", ckpt, "--video_path", str(fdir),
                     "--label_path", label, "--out", out, "--real_size",
                     str(S), "--batch", "2", "--device", "cpu",
                     "--save_correspondences"])
    want = tmr.run_gangealing_on_video(
        model, tprep.load_video_frames(str(fdir)), label_path=label,
        batch=2, save_correspondences=True)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    for name in ("propagated.mp4", "congealed.mp4", "correspondences.pt"):
        assert os.path.getsize(os.path.join(out, name)) > 0


def test_cli_mixed_reality_refuses_later_slices(tmp_path, capsys):
    with pytest.raises(SystemExit):
        tcli.main(["--ckpt", "stn.pt", "--video_path", str(tmp_path),
                   "--num_devices", "2"])
    assert "launch 2 ranks with torchrun" in capsys.readouterr().err


def test_mixed_reality_refuses_clustering(params, model):
    """Without a classifier ``cluster`` is not read, as in the JAX
    package: the apps give the same frames with and without it; a
    clustering model without its classifier is refused."""
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    x = ar_images(18, 2)
    ref = jmr.run_gangealing_on_video(jp, JCFG, x, cluster=0)
    ours = tmr.run_gangealing_on_video(model, x, cluster=0)
    _close(ours["congealed"], ref["congealed"], OUT_TOL)
    ref = jprop.propagate_to_images(jp, JCFG, x, cluster=0)
    ours = tprop.propagate_to_images(model, x, cluster=0)
    _close(ours["congealed"], ref["congealed"], OUT_TOL)
    two = tstn.ComposedSTN(dataclasses.replace(model.cfg, num_heads=2))
    for app in (tmr.run_gangealing_on_video, tprop.propagate_to_images):
        with pytest.raises(ValueError, match="cluster classifier"):
            app(two, x)


def test_entry_points_run_on_the_card_unless_asked(tmp_path, model, capped,
                                                   monkeypatch):
    """load_stn and the CLI default to the card and raise when none is
    visible; the CPU is taken only when asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ckpt = _checkpoint(tmp_path, model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_stn(ckpt, supersize=S)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["--ckpt", ckpt, "--video_path", str(tmp_path)])
    cpu_model, cfg = load_stn(ckpt, supersize=S, device="cpu")
    assert cfg == tstn.ComposedSTNConfig(**ARCH)
    assert next(cpu_model.parameters()).device.type == "cpu"
