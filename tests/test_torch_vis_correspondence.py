"""The port's correspondence videos (apps/vis_correspondence.py), their
CLI and cli/process_video.py against the JAX package's, on the CPU.

The 8 cases of tests/test_vis_correspondence.py at its size (S = 64,
similarity then flow), on the STN of tests/test_torch_ar.py (the JAX init
plus 0.2 noise, so that the warps move pixels and flips occur); the
padding and the patch search of the dense tracking; the two CLIs.

Tolerances: every video frame (uint8 grids) within 1 level; the tracked
points' patch-search picks equal, and the lerped propagated points
within 1e-4 px; pad_grid and nearest_neighbor_within_patch equal to the
bit, at every chunk size over the points; cluster buckets equal;
process_video's LMDB equal to the JAX CLI's byte for byte. On the card
(marker ``cuda``): the track pipeline's congealing frames within 1 level
of the port's CPU path, and its propagated points within 1e-4 px but for
at most 1% of them (a pick of the patch search may flip at a near tie of
two distances, as chip_smoke.py counts).
"""

import os
import sys
from importlib import import_module

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from gangealing_torch.apps import vis_correspondence as tvc
from gangealing_torch.cli import process_video as tpv_cli
from gangealing_torch.cli import vis_correspondence as tvc_cli
from gangealing_torch.io import params_from_jax
from gangealing_torch.models import classifier as tcls

from test_torch_ar import ARCH, ar_images, ar_model, ar_params
from test_torch_eval_apps import _image_lmdb, two_torch_threads  # noqa: F401
from test_torch_eval_cli import _checkpoint, capped  # noqa: F401
from test_torch_visuals import jitted_forward

jstn = import_module("gangealing_tpu.models.stn")
jvc = import_module("gangealing_tpu.apps.vis_correspondence")
jcls = import_module("gangealing_tpu.models.classifier")
jpv_cli = import_module("gangealing_tpu.cli.process_video")
jmm = import_module("gangealing_tpu.ops.mipmap")

S = 64
JCFG = jstn.ComposedSTNConfig(**ARCH)
PT_TOL = 1e-4


@pytest.fixture(scope="module")
def params():
    return ar_params()


@pytest.fixture(scope="module")
def jparams(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


@pytest.fixture(scope="module")
def model(params):
    return ar_model(params)


@pytest.fixture(autouse=True)
def jit_jax_stn(monkeypatch):
    """JAX's composed_stn_forward jitted where the JAX app and the point
    functions call it, and its mipmap warp where the app's frames call
    it."""
    forward = jitted_forward(jstn.composed_stn_forward)
    monkeypatch.setattr(jstn, "composed_stn_forward", forward)
    monkeypatch.setattr(jvc, "composed_stn_forward", forward)
    monkeypatch.setattr(jmm, "mipmap_warp", jax.jit(
        jmm.mipmap_warp, static_argnames=("max_num_levels",
                                          "padding_mode")))


def _frames_close(ours, ref):
    assert len(ours) == len(ref)
    for o, r in zip(ours, ref):
        assert o.dtype == np.uint8 and o.shape == np.asarray(r).shape
        diff = np.abs(o.astype(int) - np.asarray(r).astype(int))
        assert diff.max() <= 1, diff.max()


def _label(path, box, color):
    from PIL import Image
    rgba = np.zeros((S, S, 4), np.uint8)
    (y0, y1), (x0, x1) = box
    rgba[y0:y1, x0:x1] = color + [255]
    Image.fromarray(rgba).save(path)
    return str(path)


def _images(seed, n):
    return np.tanh(np.random.RandomState(seed).randn(n, 3, S, S).astype(
        np.float32))


def test_smooth_congeal_video(model, jparams, tmp_path):
    imgs = ar_images(0, 2)
    out = str(tmp_path / "congeal.mp4")
    ours = tvc.smooth_congeal_video(model, imgs, num_frames=4, out_path=out)
    _frames_close(ours, jvc.smooth_congeal_video(jparams, JCFG, imgs,
                                                 num_frames=4))
    assert os.path.getsize(out) > 0


def test_smooth_propagation_video(model, jparams, tmp_path):
    label = _label(tmp_path / "l.png", ((10, 20), (10, 20)), [0, 255, 0])
    imgs = ar_images(1, 2)
    kw = dict(num_frames=3, no_flip_inference=False)
    _frames_close(tvc.smooth_propagation_video(model, imgs, label, **kw),
                  jvc.smooth_propagation_video(jparams, JCFG, imgs, label,
                                               **kw))


def test_average_image_video(model, jparams):
    """4 images in batches of 3 (a tail of 1)."""
    imgs = ar_images(2, 4)
    _frames_close(tvc.average_image_video(model, imgs, num_frames=2,
                                          batch=3),
                  jvc.average_image_video(jparams, JCFG, imgs, num_frames=2,
                                          batch=3))


def test_bucket_by_cluster():
    cfg = jcls.ClassifierConfig(size=S, supersize=S, channel_multiplier=0.25,
                                num_heads=4, max_channels=32)
    p = jcls.classifier_init(jax.random.PRNGKey(0), cfg)
    classifier = tcls.Classifier(tcls.ClassifierConfig(
        size=S, supersize=S, channel_multiplier=0.25, num_heads=4,
        max_channels=32))
    classifier.load_state_dict(params_from_jax(p), strict=True)
    imgs = _images(3, 6)
    ours = tvc.bucket_real_images_by_cluster(classifier.eval(), imgs, 2,
                                             batch=4)
    ref = jvc.bucket_real_images_by_cluster(p, cfg, imgs, 2, batch=4)
    assert len(ours) == 2 and sum(len(b) for b in ours) == 6
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o, r)


def _spy(module, monkeypatch):
    """Record the points visualize_label_propagation is handed."""
    captured = {}
    orig = module.visualize_label_propagation

    def spy(images, pts, *a, **k):
        captured["pts"] = np.asarray(pts.cpu() if torch.is_tensor(pts)
                                     else pts)
        return orig(images, pts, *a, **k)
    monkeypatch.setattr(module, "visualize_label_propagation", spy)
    return captured


def _track_both(model, jparams, monkeypatch, imgs, **kw):
    got, want = _spy(tvc, monkeypatch), _spy(jvc, monkeypatch)
    ours = tvc.smoothly_congeal_and_propagate(model, imgs, **kw)
    kw.pop("out_dir", None)
    ref = jvc.smoothly_congeal_and_propagate(jparams, JCFG, imgs, **kw)
    for o, r in zip(ours, ref):
        if r is None:
            assert o is None
        else:
            _frames_close(o, r)
    if "pts" in want:
        np.testing.assert_allclose(got["pts"], want["pts"], atol=PT_TOL,
                                   rtol=0)
    return ours, got.get("pts")


def test_smoothly_congeal_and_propagate(model, jparams, tmp_path,
                                        monkeypatch):
    """The assembled dense tracking: both directions, splat_batch chunks,
    flip inference, three mp4s (tests/test_vis_correspondence.py's slow
    case)."""
    label = _label(tmp_path / "label.png", ((20, 36), (24, 40)), [255, 0, 0])
    out_dir = str(tmp_path / "vids")
    os.makedirs(out_dir)
    (congeal, prop), _ = _track_both(
        model, jparams, monkeypatch, ar_images(4, 4), label_path=label,
        length=4, output_resolution=S, resolution=S, splat_batch=3,
        no_flip_inference=False, out_dir=out_dir, fps=10)
    assert len(congeal) == 4 and len(prop) == 4
    for name in ("smoothly_congeal.mp4", "smoothly_propagate.mp4",
                 "smooth_correspondence.mp4"):
        assert os.path.getsize(os.path.join(out_dir, name)) > 0


def test_smoothly_congeal_in_stages_no_label(model, jparams, monkeypatch):
    (frames, prop), _ = _track_both(
        model, jparams, monkeypatch, ar_images(5, 2), length=3,
        vis_in_stages=True, output_resolution=S, no_flip_inference=True)
    assert prop is None and len(frames) == 6  # 2 stages x 3 frames


def test_bidirectional_tracking_pins_congealed_end(model, jparams, tmp_path,
                                                   monkeypatch):
    """At the fully congealed frame the tracked points are the label's
    own coordinates, as the reverse pass guarantees."""
    from gangealing_torch.utils.vis import load_dense_label
    label = _label(tmp_path / "label.png", ((8, 12), (8, 12)), [0, 0, 255])
    _, pts = _track_both(model, jparams, monkeypatch, ar_images(6, 2),
                         label_path=label, length=4, output_resolution=S,
                         resolution=S, no_flip_inference=True)
    points, _, _ = load_dense_label(label, resolution=S)
    np.testing.assert_allclose(pts[-1], np.round(points.numpy())[0][None]
                               .repeat(2, 0), atol=1e-4)


def test_stage_flip_frames(model, jparams, tmp_path, monkeypatch):
    """--stage_flip puts the mirror animation (and the label's
    propagation over it) before the warp stages, in stages, with label
    colours."""
    from PIL import Image
    rgba = np.zeros((S, S, 4), np.uint8)
    rgba[8:16, 8:16] = [0, 255, 0, 255]
    rgba[30:40, 20:44] = [200, 30, 90, 255]
    Image.fromarray(rgba).save(tmp_path / "l.png")
    (congeal, prop), _ = _track_both(
        model, jparams, monkeypatch, ar_images(7, 2),
        label_path=str(tmp_path / "l.png"), length=3, flip_length=2,
        stage_flip=True, vis_in_stages=True, objects=True,
        output_resolution=S, resolution=S, no_flip_inference=False)
    assert len(congeal) == 2 + 2 * 3
    assert len(prop) == 2 * 3 + 2


# ---------------------------------------------------------------------------
# the padding and the patch search
# ---------------------------------------------------------------------------

def test_pad_grid_equals_jax():
    grid = np.random.RandomState(8).randn(3, 5, 7, 2).astype(np.float32)
    np.testing.assert_array_equal(
        tvc.pad_grid(torch.from_numpy(grid)).numpy(),
        np.asarray(jvc.pad_grid(jnp.asarray(grid))))


@pytest.mark.parametrize("chunk", [None, 1, 7, 50, 64])
def test_nearest_neighbor_within_patch_equals_jax(chunk, monkeypatch):
    """A smooth grid with ties (repeated rows) at 50 points of which some
    sit on the border and outside it, in 5 x 5 windows; chunk edges at
    1, 7 and 50 points and one chunk past the end (NN_CHUNK_ELEMENTS set
    to that many points' distances; None keeps the default)."""
    rng = np.random.RandomState(9)
    N, H, W, P = 2, 12, 10, 50
    grid = np.cumsum(rng.rand(N, H, W, 2).astype(np.float32) * 0.2, axis=1)
    grid[:, 4] = grid[:, 3]  # exact ties: the first in window order wins
    points = grid[:, rng.randint(0, H, P), rng.randint(0, W, P)] + \
        rng.randn(N, P, 2).astype(np.float32) * 0.05
    centers = np.stack([rng.randint(-1, W + 1, (N, P)),
                        rng.randint(-1, H + 1, (N, P))], -1).astype(np.int32)
    ref = np.asarray(jvc.nearest_neighbor_within_patch(
        jnp.asarray(grid), jnp.asarray(points), jnp.asarray(centers), 5))
    if chunk is not None:
        monkeypatch.setattr(tvc, "NN_CHUNK_ELEMENTS", chunk * N * 5 * 5)
    ours = tvc.nearest_neighbor_within_patch(
        torch.from_numpy(grid), torch.from_numpy(points),
        torch.from_numpy(centers), 5)
    np.testing.assert_array_equal(ours.numpy(), ref)


def test_patch_size_and_label_resolution_match_jax():
    for length in (1, 4, 59, 60, 61, 240, 500):
        assert tvc.get_patch_size(length) == jvc.get_patch_size(length)
    for m in (0.0, 1.0, 63.0, 64.0, 200.5):
        pts = np.array([[[m, 0.0]]], np.float32)
        assert tvc.points_resolution_default(torch.from_numpy(pts)) == \
            jvc.points_resolution_default(pts)
    np.testing.assert_array_equal(tvc.interpolation_alphas(7, 2),
                                  jvc.interpolation_alphas(7, 2))


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

@pytest.fixture
def track_data(tmp_path, model):
    ckpt = _checkpoint(tmp_path, model)
    data = _image_lmdb(tmp_path / "data", ar_images(10, 5))
    label = _label(tmp_path / "label.png", ((20, 36), (24, 40)), [255, 0, 0])
    return ckpt, data, label


@pytest.mark.parametrize("mode", ["track", "congeal", "propagate",
                                  "average"])
def test_cli_vis_correspondence_on_the_cpu(tmp_path, model, track_data,
                                           capped, mode):
    """python -m gangealing_torch.cli.vis_correspondence --device cpu:
    the app's frames on the LMDB's selected images, its video written;
    track filters the dataset by flow scores first (the 3 best of 5)."""
    from gangealing_torch.apps.flow_scores import compute_flow_scores
    from gangealing_torch.data.dataset import MultiResolutionDataset
    ckpt, data, label = track_data
    out = str(tmp_path / "out")
    argv = ["--ckpt", ckpt, "--real_data_path", data, "--real_size", str(S),
            "--resolution", str(S), "--out", out, "--length", "3",
            "--device", "cpu", "--mode", mode, "--dset_indices", "0", "2",
            "7", "--label_path", label]
    dset = MultiResolutionDataset(data, S)
    idx = [0, 2]
    if mode == "track":
        scores = compute_flow_scores(model, data, real_size=S, batch=2,
                                     save=True, device="cpu")
        argv += ["--flow_scores", os.path.join(data, "flow_scores.pt"),
                 "--fraction_retained", "0.6", "--objects"]
        keep = np.where(scores > np.quantile(scores, 0.4))[0]
        idx = [int(keep[i]) for i in idx]
    got = tvc_cli.main(argv)
    imgs = np.stack([dset[i] for i in idx])
    if mode == "track":
        want = tvc.smoothly_congeal_and_propagate(
            model, imgs, label_path=label, length=3, output_resolution=S,
            resolution=S, objects=True)
        names = ("smoothly_congeal.mp4", "smoothly_propagate.mp4",
                 "smooth_correspondence.mp4")
        got, want = got[0] + got[1], want[0] + want[1]
    else:
        fn = {"congeal": tvc.smooth_congeal_video,
              "propagate": lambda m, x, n: tvc.smooth_propagation_video(
                  m, x, label, n),
              "average": tvc.average_image_video}[mode]
        want = fn(model, imgs, 3)
        names = (f"{mode}.mp4",)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for name in names:
        assert os.path.getsize(os.path.join(out, name)) > 0


def test_cli_vis_correspondence_refuses_later_slices_and_needs_a_card(
        tmp_path, capsys, monkeypatch, track_data):
    ckpt, data, _ = track_data
    with pytest.raises(SystemExit):
        tvc_cli.main(["--ckpt", ckpt, "--real_data_path", data,
                      "--num_devices", "2"])
    assert "launch 2 ranks with torchrun" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tvc_cli.vis_correspondence_argparse().parse_args(
        ["--ckpt", ckpt]).device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tvc_cli.main(["--ckpt", ckpt, "--real_data_path", data])


def _write_video(path, n, size=(80, 64)):
    import cv2
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 10,
                             size)
    rng = np.random.RandomState(11)
    for i in range(n):
        frame = np.full((size[1], size[0], 3), 20 * i % 255, np.uint8)
        frame[8:40, 10 + i:40 + i] = rng.randint(0, 255, 3)
        writer.write(frame)
    writer.release()
    return str(path)


@pytest.mark.parametrize("extra", [[], ["--size", "32,48", "--pad", "zero",
                                        "--max_frames", "3"]])
def test_process_video_lmdb_equals_jax(tmp_path, monkeypatch, extra):
    """The same frames, sizes and pad mode into an LMDB equal to the JAX
    CLI's byte for byte, read back by the port's dataset."""
    from gangealing_torch.data.dataset import MultiResolutionDataset
    video = _write_video(tmp_path / "v.mp4", 6)
    ours, ref = str(tmp_path / "ours"), str(tmp_path / "ref")
    n = tpv_cli.main(["--video", video, "--out", ours, "--size", "32"]
                     + extra)
    monkeypatch.setattr(sys, "argv", ["process_video", "--video", video,
                                      "--out", ref, "--size", "32"] + extra)
    jpv_cli.main()
    assert n == (3 if extra else 6)
    assert sorted(os.listdir(ours)) == sorted(os.listdir(ref))
    for name in os.listdir(ref):
        with open(os.path.join(ours, name), "rb") as a, \
                open(os.path.join(ref, name), "rb") as b:
            assert a.read() == b.read(), name
    size = 48 if extra else 32
    dset = MultiResolutionDataset(ours, resolution=size)
    assert len(dset) == n and dset[n - 1].shape == (3, size, size)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_track_on_the_card_matches_the_cpu_path(cuda, model, params,
                                                tmp_path, monkeypatch):
    """The track pipeline with a label, flips and stages on the card (K1,
    K2 and K6) against the port's CPU path."""
    label = _label(tmp_path / "label.png", ((20, 36), (24, 40)), [255, 0, 0])
    kw = dict(label_path=label, length=4, output_resolution=S,
              resolution=S, splat_batch=3, vis_in_stages=True,
              stage_flip=True, flip_length=2, objects=True)
    imgs = ar_images(12, 4)
    got = _spy(tvc, monkeypatch)
    card, _ = tvc.smoothly_congeal_and_propagate(ar_model(params).to(cuda),
                                                 imgs, **kw)
    card_pts = got.pop("pts")
    cpu, _ = tvc.smoothly_congeal_and_propagate(model, imgs, **kw)
    _frames_close(card, cpu)
    far = (np.abs(card_pts - got["pts"]) > PT_TOL).any(-1)
    assert far.mean() <= 0.01, far.mean()
