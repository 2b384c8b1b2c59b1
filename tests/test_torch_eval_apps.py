"""The port's eval apps (apps/pck.py, apps/flow_scores.py,
apps/congeal_dataset.py) and their CLIs against the JAX package's, on the
CPU, over synthetic LMDBs written as tests/test_apps.py writes them.

The STN is that of tests/test_torch_points.py (S=64, noise 0.2 on its
weights); the images are smooth (tests/test_torch_ar.py), stored as PNG.
Tolerances: transferred points within 1e-3 px, held before the PCK values
they decide, which must then be equal; flow scores within 1e-5 relative,
and the indices a filter keeps equal; congeal_dataset's accepted indices
equal, its LMDB equal in keys, its aligned images within 1/255 after
decoding (a float difference can move a uint8 value by one); the CLIs
equal to the app functions they call.
"""

import io
import os
from importlib import import_module

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gangealing_torch.apps import congeal_dataset as tcong
from gangealing_torch.apps import flow_scores as tflow
from gangealing_torch.apps import pck as tpck
from gangealing_torch.data import dataset as tds
from gangealing_torch.data.lmdb_io import LMDBReader, write_lmdb
from gangealing_torch.models import stn as tstn

from test_torch_ar import ARCH, ar_images, ar_model, ar_params

jstn = import_module("gangealing_tpu.models.stn")
jds = import_module("gangealing_tpu.data.dataset")
jpck = import_module("gangealing_tpu.apps.pck")
jflow = import_module("gangealing_tpu.apps.flow_scores")
jcong = import_module("gangealing_tpu.apps.congeal_dataset")

S = 64
JCFG = jstn.ComposedSTNConfig(**ARCH)
PT_TOL, SCORE_RTOL = 1e-3, 1e-5
ALPHAS = (0.1, 0.05, 0.01)


@pytest.fixture(autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    return ar_params()


@pytest.fixture(scope="module")
def model(params):
    return ar_model(params)


@pytest.fixture(scope="module")
def jparams(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


@pytest.fixture(scope="module")
def zoom_params(params):
    """The similarity head's noise cut to a twentieth and its scale output
    shifted to zoom in by about 11%: under the noise of 0.2 every warp
    leaves the image and congeal_dataset would reject every image."""
    p = dict(params)
    for k in ("stns.0.warp_head.linear.weight",
              "stns.0.warp_head.linear.bias"):
        p[k] = params[k] * 0.05
    p["stns.0.warp_head.linear.bias"][1] -= 0.12
    return p


def _png(img):
    """A (3, H, W) image in [-1, 1] as PNG bytes."""
    from PIL import Image
    arr = np.round((img + 1) * 127.5).clip(0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr.transpose(1, 2, 0)).save(buf, format="PNG")
    return buf.getvalue()


def _image_lmdb(path, imgs, res=S):
    items = {b"length": str(len(imgs)).encode()}
    for i, img in enumerate(imgs):
        items[f"{res}-{str(i).zfill(5)}".encode()] = _png(img)
    write_lmdb(str(path), items)
    return str(path)


@pytest.fixture(scope="module")
def pck_lmdbs(tmp_path_factory):
    """10 images in 5 fixed pairs: pairs 0, 2 and 4 one image twice with
    the same key points (a transfer lands near them), pairs 1 and 3 two
    images of tests/test_torch_points.py; 5 key points with visibility, a
    left-right permutation; with SPair's threshold sidecars and without."""
    root = tmp_path_factory.mktemp("pck")
    imgs = np.empty((10, 3, S, S), np.float32)
    imgs[0::2], imgs[1::2] = ar_images(32, 5), ar_images(132, 5)
    rng = np.random.RandomState(5)
    kps = np.concatenate([rng.rand(10, 5, 2) * (S - 1),
                          rng.rand(10, 5, 1) > 0.2], 2).astype(np.float32)
    for i in (0, 4, 8):
        imgs[i + 1], kps[i + 1] = imgs[i], kps[i]
    paths = {}
    for name in ("spair", "plain"):
        path = _image_lmdb(root / name, imgs)
        torch.save(torch.from_numpy(kps), os.path.join(path, "keypoints.pt"))
        torch.save(torch.arange(10).view(5, 2),
                   os.path.join(path, "pairs.pt"))
        torch.save([1, 0, 2, 4, 3], os.path.join(path, "permutation.pt"))
        if name == "spair":
            torch.save(torch.from_numpy(rng.rand(10).astype(np.float32)
                                        * 30 + 20),
                       os.path.join(path, "pck_thresholds.pt"))
            torch.save(torch.from_numpy(np.concatenate(
                [np.zeros((10, 2)), rng.rand(10, 1) + 0.5], 1).astype(
                    np.float32)), os.path.join(path, "inverse_coordinates.pt"))
        paths[name] = path
    return paths


def _transfers(transfer, d, permutation, match_flows, both_ways):
    """The points one PCK batch transfers A to B (and B to A)."""
    kA, kB = d["kpsA"][..., :2], d["kpsB"][..., :2]
    imgsA, imgsB = d["imgsA"], d["imgsB"]
    if match_flows:
        imgsA, imgsB, kA, kB = transfer("match", imgsA, imgsB, kA, kB,
                                        permutation)[:4]
    moved = [transfer("move", imgsA, imgsB, kA)]
    if both_ways:
        moved.append(transfer("move", imgsB, imgsA, kB))
    return moved


@pytest.mark.parametrize("name,match_flows,both_ways,num_pairs", [
    ("spair", True, False, None), ("plain", False, True, 4)])
def test_pck_transfer_matches_jax(model, jparams, pck_lmdbs, name,
                                  match_flows, both_ways, num_pairs):
    """Batches of 2 (a tail batch of 1 unless num_pairs cuts it): the
    transferred points of the first batch, then the PCK values."""
    path = pck_lmdbs[name]
    perm = np.array([1, 0, 2, 4, 3])
    ours_d, ref_d = tds.PCKDataset(path, S), jds.PCKDataset(path, S)
    d = next(iter(jds.DataLoader(ref_d, batch_size=2, drop_last=False)))

    def ours_fn(what, *a):
        a = [torch.from_numpy(np.array(x)) if isinstance(x, np.ndarray)
             else x for x in a]
        with torch.no_grad():
            if what == "match":
                return tstn.composed_match_flows(model, *a[:4],
                                                 permutation=a[4])
            return tstn.composed_transfer_points(model, *a)

    def ref_fn(what, *a):
        a = [jnp.asarray(x) if isinstance(x, np.ndarray) else x for x in a]
        if what == "match":
            return jstn.composed_match_flows(jparams, JCFG, *a[:4],
                                             permutation=a[4])
        return jstn.composed_transfer_points(jparams, JCFG, *a)

    ours_pts = _transfers(ours_fn, d, perm, match_flows, both_ways)
    for a, b in zip(ours_pts, _transfers(ref_fn, d, perm, match_flows,
                                         both_ways)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=PT_TOL,
                                   rtol=0)
    kw = dict(alphas=ALPHAS, num_pairs=num_pairs, match_flows=match_flows,
              transfer_both_ways=both_ways, permutation=perm)
    ours = tpck.pck_transfer(
        model, tds.DataLoader(ours_d, batch_size=2, drop_last=False), **kw)
    ref = jpck.pck_transfer(
        jparams, JCFG, jds.DataLoader(ref_d, batch_size=2, drop_last=False),
        batch_size=2, **kw)
    print(f"PCK {name}: {ours} (JAX {ref})")
    np.testing.assert_array_equal(ours, ref)
    assert 0 < ours[0] < 1


def _decoded(path):
    from PIL import Image
    return np.asarray(Image.open(path).convert("RGB"), np.int32)


def test_vis_transfer_matches_jax(tmp_path, model, jparams, pck_lmdbs):
    """The congealed grid within 1/255 of the JAX package's; the transfer
    grid and the per-image overlays of the same sizes. Its markers are
    drawn with PIL here and with matplotlib there, so their pixels are
    not compared."""
    path = pck_lmdbs["spair"]
    perm = np.array([1, 0, 2, 4, 3])
    grids = []
    for name, fn, args in (
            ("ours", tpck.vis_transfer, (model,)),
            ("ref", jpck.vis_transfer, (jparams, JCFG))):
        dset = (tds if name == "ours" else jds).PCKDataset(path, S)
        loader = (tds if name == "ours" else jds).DataLoader(
            dset, batch_size=2, drop_last=False)
        grids.append(fn(*args, loader, permutation=perm,
                        out_dir=str(tmp_path / name), num_to_vis=2))
    cong = [_decoded(str(tmp_path / n / "transfers" / "congealed.png"))
            for n in ("ours", "ref")]
    assert np.abs(cong[0] - cong[1]).max() <= 1
    assert _decoded(grids[0]).shape == _decoded(grids[1]).shape
    for i in range(4):
        assert _decoded(str(tmp_path / "ours" / "transfers" /
                            f"{i:04d}.png")).shape == (S, S, 3)


@pytest.fixture(scope="module")
def img_lmdb(tmp_path_factory):
    return _image_lmdb(tmp_path_factory.mktemp("imgs") / "data",
                       ar_images(40, 9))


@pytest.mark.parametrize("no_flip_inference", [False, True])
def test_flow_scores_and_filter_match_jax(tmp_path, model, jparams, img_lmdb,
                                          no_flip_inference):
    """Batches of 4 (a tail of 1); the cache each package writes read by
    the other; the images a 0.5 filter keeps."""
    import shutil
    data = str(tmp_path / "data")
    shutil.copytree(img_lmdb, data)
    kw = dict(real_size=S, batch=4, no_flip_inference=no_flip_inference)
    ref = jflow.compute_flow_scores(jparams, JCFG, data, save=False, **kw)
    ours = tflow.compute_flow_scores(model, data, device="cpu", **kw)
    np.testing.assert_allclose(ours, ref, rtol=SCORE_RTOL, atol=0)
    np.testing.assert_array_equal(
        jflow.get_flow_scores(jparams, JCFG, data), ours)  # our cache
    os.remove(os.path.join(data, "flow_scores.pt"))
    jflow.compute_flow_scores(jparams, JCFG, data, save=True, **kw)
    np.testing.assert_array_equal(tflow.get_flow_scores(model, data), ref)
    kept = tflow.filter_dataset(tds.MultiResolutionDataset(data, S), ours,
                                0.5).indices
    assert kept == jflow.filter_dataset(jds.MultiResolutionDataset(data, S),
                                        ref, 0.5).indices
    assert kept == tflow.filter_dataset(
        None, os.path.join(data, "flow_scores.pt"), 0.5).indices
    assert len(kept) == 4


def _lmdb_images(path):
    """The decoded images of an LMDB by key, and its length."""
    from PIL import Image
    from gangealing_torch.data.lmdb_io import iterate_keys
    r = LMDBReader(path)
    keys = [k for k in iterate_keys(path) if k != b"length"]
    return {k: np.asarray(Image.open(io.BytesIO(r.get(k))).convert("RGB"),
                          np.int32) for k in keys}, r.get(b"length")


def _congealed_equal(ours, ref, ours_out, ref_out):
    assert ours == ref
    imgs, n = _lmdb_images(ours_out)
    ref_imgs, ref_n = _lmdb_images(ref_out)
    assert n == ref_n == str(len(ref)).encode()
    assert sorted(imgs) == sorted(ref_imgs)
    for k in ref_imgs:
        assert np.abs(imgs[k] - ref_imgs[k]).max() <= 1, k
    assert torch.equal(
        torch.load(os.path.join(ours_out, "dataset_indices.pt")),
        torch.load(os.path.join(ref_out, "dataset_indices.pt")))


def test_congeal_dataset_matches_jax(tmp_path, zoom_params, img_lmdb):
    """Batches of 4 (a tail of 1), filtered by flow scores to 7 of 9
    images, a threshold that accepts some and rejects others (effective
    resolutions of 59.4 to 60.9 against 60, and one warp out of bounds),
    and a stale PNG of an earlier run that must not reach the LMDB."""
    model = ar_model(zoom_params)
    jparams = {k: jnp.asarray(v) for k, v in zoom_params.items()}
    scores = str(tmp_path / "scores.pt")
    torch.save(torch.linspace(1, 0, 9), scores)
    kw = dict(real_size=S, flow_size=S, output_resolution=32, batch=4,
              min_effective_resolution=60, flow_scores_path=scores,
              fraction_retained=0.8)
    outs = [str(tmp_path / n) for n in ("ours", "ref")]
    for out in outs:
        os.makedirs(f"{out}_imagefolder")
        open(f"{out}_imagefolder/9999999.png", "wb").close()
    ours = tcong.align_and_filter_dataset(model, img_lmdb, outs[0],
                                          device="cpu", **kw)
    ref = jcong.align_and_filter_dataset(jparams, JCFG, img_lmdb, outs[1],
                                         **kw)
    print(f"congeal_dataset accepted {ours} of 7")
    assert 0 < len(ours) < 7
    _congealed_equal(ours, ref, *outs)


def test_congeal_dataset_native_size_matches_jax(tmp_path, zoom_params):
    """real_size 0: images of their own sizes under '0-' keys, each
    border-padded to its square and placed on the largest one's canvas."""
    model = ar_model(zoom_params)
    jparams = {k: jnp.asarray(v) for k, v in zoom_params.items()}
    sizes = [(48, 64), (64, 40), (56, 56), (30, 50), (64, 64)]
    imgs = [ar_images(50 + i, 1)[0][:, :h, :w]
            for i, (h, w) in enumerate(sizes)]
    items = {b"length": b"5"}
    for i, img in enumerate(imgs):
        items[f"0-{str(i).zfill(5)}".encode()] = _png(img)
    data = str(tmp_path / "native")
    write_lmdb(data, items)
    kw = dict(real_size=0, flow_size=S, output_resolution=32, batch=2,
              min_effective_resolution=0)
    outs = [str(tmp_path / n) for n in ("ours", "ref")]
    ours = tcong.align_and_filter_dataset(model, data, outs[0],
                                          device="cpu", **kw)
    ref = jcong.align_and_filter_dataset(jparams, JCFG, data, outs[1], **kw)
    assert len(ours) > 0
    _congealed_equal(ours, ref, *outs)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_pck_batch_kernels_match_plain_on_the_card(cuda, params, pck_lmdbs,
                                                   monkeypatch):
    """One PCK batch with the 4-way match, both ways: 10 K1 launches (the
    match's forward at 4N and, each way, the congealing stages and the
    target's forward) and 2 K2 launches (each way's grid sampled at the
    points), each within 1e-5 of its plain version on the inputs it got;
    the PCK counts equal to the port's CPU path's."""
    from gangealing_torch.ops import grid_sample as tgs
    from gangealing_torch.ops import mipmap as tmm
    calls = {"k1": [], "k2": []}

    def record(module, name, key):
        fn = getattr(module, name)

        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            calls[key].append((a + tuple(kw.values()), out))
            return out
        monkeypatch.setattr(module, name, wrapped)

    record(tmm, "mipmap_sample", "k1")
    record(tgs, "grid_sample_cuda", "k2")
    dset = tds.PCKDataset(pck_lmdbs["spair"], S)
    d = next(iter(tds.DataLoader(dset, batch_size=4, drop_last=False)))
    card = ar_model(params).to(cuda)
    kw = dict(alphas=ALPHAS, transfer_both_ways=True,
              permutation=dset.mirror_permutation)
    with torch.inference_mode():
        got = tpck.pck_batch(card, *tpck.batch_tensors(d, cuda), **kw)
        want = tpck.pck_batch(ar_model(params),
                              *tpck.batch_tensors(d, "cpu"), **kw)
        assert len(calls["k1"]) == 10 and len(calls["k2"]) == 2
        for a, out in calls["k1"]:
            ref = tmm._sample_pyramid(*a)
            assert float((out - ref).abs().max()) <= 1e-5
        for a, out in calls["k2"]:
            ref = tgs.grid_sample(a[0], a[1], padding_mode=a[2])
            assert float((out - ref).abs().max()) <= 1e-5
    assert torch.equal(got[0].cpu(), want[0]) and float(got[1]) == float(
        want[1])


def test_batch_overlay_matches_jax(tmp_path):
    """The overlay the JAX package draws with matplotlib, drawn with PIL:
    images of the same size, each marker in the colour matplotlib's
    'turbo' gives its point (within one 8-bit step), and
    away from the markers the image itself within one 8-bit step."""
    jvis = import_module("gangealing_tpu.utils.vis")
    from gangealing_torch.utils import vis as tvis
    rng = np.random.RandomState(13)
    imgs = np.tanh(rng.randn(2, 3, 40, 48)).astype(np.float32)
    grid = np.array([(6, 6), (20, 8), (34, 6), (8, 30), (22, 26),
                     (40, 32)], np.float32)  # markers that do not overlap
    pts = grid + rng.uniform(-1.5, 1.5, (2, 6, 2)).astype(np.float32)
    ours = tvis.batch_overlay(imgs, pts, None, str(tmp_path / "o"),
                              unique_color=True, size=10)
    ref = jvis.batch_overlay(imgs, pts, None, str(tmp_path / "r"),
                             unique_color=True, size=10)
    colours = np.asarray(jvis.get_colors(6, "turbo"))[0] * 0.5 + 0.5
    for i in range(2):
        assert ours[i].shape == ref[i].shape == (40, 48, 3)
        assert os.path.exists(tmp_path / "o" / f"{i:04d}.png")
        for (x, y), c in zip(pts[i], colours):
            got = ours[i][int(round(y)), int(round(x))]
            assert np.abs(got / 255.0 - c).max() <= 1 / 255
        far = np.ones((40, 48), bool)
        for x, y in pts[i]:
            far[max(0, int(y) - 4):int(y) + 5, max(0, int(x) - 4):int(x) + 5] \
                = False
        want = np.round((imgs[i].transpose(1, 2, 0) + 1) * 127.5)
        assert np.abs(ours[i][far] - want[far]).max() <= 1
