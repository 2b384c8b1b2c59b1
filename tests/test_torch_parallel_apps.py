"""The port's eval and AR apps on two gloo ranks on the CPU, each rank on
its stride of the images, frames or pairs, held against the JAX package's
single-controller results: flow scores, PCK-Transfer, congeal_dataset,
propagate_to_images, the mixed-reality video (also with one frame, where
rank 1's stripe is empty), the average-image video and the bucketing of
real images by cluster.

One spawn runs every app (tests/torch_parallel_worker.py::apps) with its
own timeout, which also bounds each collective. The STN, images and
datasets are those of tests/test_torch_eval_apps.py,
tests/test_torch_ar_apps.py and tests/test_torch_vis_correspondence.py,
sized so that the stripes are uneven. Tolerances are those tests': flow
scores 1e-5 relative; the PCK values equal (over 4 pairs, 2 a rank, so no
pair is counted twice); congeal_dataset's indices equal and its LMDB's
images within 1/255, rank 0's accepted images first, as each rank writes
its PNGs under its own prefix; congealed images 5e-4 and propagated
frames 1e-3; transferred points 1e-3 px; the average-image frames within
one uint8 level; the buckets equal. Both ranks return the same results.
"""

import os
import shutil
from importlib import import_module

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import torch_parallel_worker as worker
from gangealing_torch.io import params_from_jax
from gangealing_torch.models import classifier as tcls
from gangealing_torch.models import stn as tstn
from gangealing_torch.parallel.launch import spawn_ranks

from test_torch_ar import ARCH, ar_images, label_png
from test_torch_eval_apps import (  # noqa: F401
    _image_lmdb, _lmdb_images, img_lmdb, jparams, model, params, pck_lmdbs,
    two_torch_threads, zoom_params)

jstn = import_module("gangealing_tpu.models.stn")
jds = import_module("gangealing_tpu.data.dataset")
jpck = import_module("gangealing_tpu.apps.pck")
jflow = import_module("gangealing_tpu.apps.flow_scores")
jcong = import_module("gangealing_tpu.apps.congeal_dataset")
jprop = import_module("gangealing_tpu.apps.propagate_to_images")
jmr = import_module("gangealing_tpu.apps.mixed_reality")
jvc = import_module("gangealing_tpu.apps.vis_correspondence")
jcls = import_module("gangealing_tpu.models.classifier")

S, WORLD = 64, 2
SPAWN_TIMEOUT = 120
JCFG = jstn.ComposedSTNConfig(**ARCH)
CLS_CFG = jcls.ClassifierConfig(size=S, supersize=S, channel_multiplier=0.25,
                                num_heads=4, max_channels=32)
SCORE_RTOL, PT_TOL, OUT_TOL, PROP_TOL = 1e-5, 1e-3, 5e-4, 1e-3
ALPHAS = (0.1, 0.05, 0.01)
PCK_KW = dict(alphas=ALPHAS, match_flows=True, transfer_both_ways=True,
              permutation=np.array([1, 0, 2, 4, 3]))
SCORES_KW = dict(real_size=S, batch=2)
CONGEAL_KW = dict(real_size=S, flow_size=S, output_resolution=32, batch=2,
                  min_effective_resolution=60, fraction_retained=0.8)
VIDEO_KW = dict(batch=2, sigma=1.2, save_correspondences=True)


@pytest.fixture(scope="module")
def setup(tmp_path_factory, params, zoom_params, pck_lmdbs, img_lmdb):
    root = tmp_path_factory.mktemp("apps")
    scores_data = str(root / "scores")
    shutil.copytree(img_lmdb, scores_data)
    flow_scores = str(root / "flow_scores.pt")
    torch.save(torch.linspace(1, 0, 9), flow_scores)
    cls_params = {k: np.asarray(v) for k, v in jcls.classifier_init(
        jax.random.PRNGKey(0), CLS_CFG).items()}
    d = dict(
        S=S, stn_cfg=tstn.ComposedSTNConfig(**ARCH),
        stn=params_from_jax(params), zoom=params_from_jax(zoom_params),
        cls_cfg=tcls.ClassifierConfig(**CLS_CFG.__dict__),
        classifier=params_from_jax(cls_params),
        scores=scores_data, scores_kw=SCORES_KW,
        pck=pck_lmdbs["spair"], num_pairs=4, pck_kw=PCK_KW,
        images=img_lmdb, congealed=str(root / "congealed"),
        congeal_kw=dict(CONGEAL_KW, flow_scores_path=flow_scores),
        prop_images=ar_images(15, 5), prop_out=str(root / "prop"),
        prop_kw=dict(label_path=label_png(root / "label.png"), batch=2,
                     objects=True),
        frames=np.concatenate([ar_images(12, 3)] * 2, axis=3)[..., 20:30 + S],
        video_out=str(root / "mr"),
        video_kw=dict(VIDEO_KW, label_path=str(root / "label.png")),
        avg_images=ar_images(2, 5),
        bucket_images=np.tanh(np.random.RandomState(3).randn(
            5, 3, S, S).astype(np.float32)))
    data = str(root / "data.pt")
    torch.save(d, data)
    spawn_ranks(worker.apps, WORLD, args=(data, str(root)),
                timeout=SPAWN_TIMEOUT)
    res = [torch.load(root / f"apps_r{r}.pt", weights_only=False)
           for r in range(WORLD)]
    return d, res, cls_params, root


def _both(res, key):
    """Rank 0's result of ``key``, after checking rank 1 returned the
    same."""
    a, b = res[0][key], res[1][key]
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
    else:
        for x, y in zip(a, b) if isinstance(a, list) else [(a, b)]:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    return a


def _close(ours, ref, atol):
    np.testing.assert_allclose(ours, np.asarray(ref), atol=atol, rtol=0)


def test_flow_scores_over_two_ranks(setup, jparams):
    d, res, _, _ = setup
    ours = _both(res, "scores")
    ref = jflow.compute_flow_scores(jparams, JCFG, d["scores"], save=False,
                                    **SCORES_KW)
    assert ours.shape == (9,)
    np.testing.assert_allclose(ours, ref, rtol=SCORE_RTOL, atol=0)
    cached = torch.load(os.path.join(d["scores"], "flow_scores.pt"))
    np.testing.assert_array_equal(cached.numpy(), ours)  # rank 0 wrote it


def test_pck_over_two_ranks(setup, jparams):
    d, res, _, _ = setup
    ours = _both(res, "pck")
    ref = jpck.pck_transfer(
        jparams, JCFG, jds.DataLoader(jds.PCKDataset(d["pck"], S),
                                      batch_size=2, drop_last=False),
        num_pairs=4, batch_size=2, **PCK_KW)
    np.testing.assert_array_equal(ours, ref)
    assert 0 < ours[0] < 1


def test_congeal_dataset_over_two_ranks(setup, zoom_params):
    d, res, _, root = setup
    ours = _both(res, "used")
    out = str(root / "ref")
    ref = jcong.align_and_filter_dataset(
        {k: jnp.asarray(v) for k, v in zoom_params.items()}, JCFG,
        d["images"], out, **d["congeal_kw"])
    assert ours == ref and 0 < len(ours) < 7
    imgs, n = _lmdb_images(d["congealed"])
    ref_imgs, ref_n = _lmdb_images(out)
    assert n == ref_n == str(len(ref)).encode()
    # rank r aligned positions r, r + 2, ... of the filtered dataset and
    # wrote its accepted images under its prefix: rank 0's come first
    kept = jflow.filter_dataset(jds.MultiResolutionDataset(d["images"], S),
                                d["congeal_kw"]["flow_scores_path"],
                                0.8).indices
    order = [i for r in range(WORLD) for p, i in enumerate(kept)
             if p % WORLD == r and i in ref]
    ours_keys, ref_keys = sorted(imgs), sorted(ref_imgs)
    assert len(ours_keys) == len(ref_keys) == len(order)
    for key, i in zip(ours_keys, order):
        assert np.abs(imgs[key] - ref_imgs[ref_keys[ref.index(i)]]).max() \
            <= 1, (key, i)
    assert torch.load(os.path.join(d["congealed"],
                                   "dataset_indices.pt")).tolist() == ref


def test_propagate_to_images_over_two_ranks(setup, jparams):
    d, res, _, _ = setup
    ours = _both(res, "propagated")
    ref = jprop.propagate_to_images(jparams, JCFG, d["prop_images"],
                                    **d["prop_kw"])
    assert set(ours) == set(ref)
    for key in ("congealed", "average_congealed"):
        _close(ours[key], ref[key], OUT_TOL)
    _close(ours["propagated"], ref["propagated"], PROP_TOL)
    for name in ("congealed.png", "average_congealed.png", "propagated.png"):
        assert os.path.getsize(os.path.join(d["prop_out"], name)) > 0


@pytest.mark.parametrize("key,n", [("video", 3), ("one_frame", 1)])
def test_mixed_reality_over_two_ranks(setup, jparams, key, n):
    d, res, _, _ = setup
    ours = _both(res, key)
    ref = jmr.run_gangealing_on_video(jparams, JCFG, d["frames"][:n],
                                      **d["video_kw"])
    assert set(ours) == set(ref)
    assert ours["congealed"].shape == (n, 3, S, S)
    _close(ours["correspondences"], ref["correspondences"], PT_TOL)
    _close(ours["congealed"], ref["congealed"], OUT_TOL)
    _close(ours["propagated"], ref["propagated"], PROP_TOL)
    if key == "video":
        for name in ("propagated.mp4", "congealed.mp4", "correspondences.pt"):
            assert os.path.getsize(os.path.join(d["video_out"], name)) > 0


def test_average_image_video_over_two_ranks(setup, jparams):
    d, res, _, _ = setup
    ours = _both(res, "average")
    ref = jvc.average_image_video(jparams, JCFG, d["avg_images"],
                                  num_frames=2, batch=2)
    assert len(ours) == len(ref) == 2
    for o, r in zip(ours, ref):
        assert o.dtype == np.uint8 and o.shape == np.asarray(r).shape
        assert np.abs(o.astype(int) - np.asarray(r).astype(int)).max() <= 1


def test_bucket_real_images_over_two_ranks(setup):
    d, res, cls_params, _ = setup
    ours = _both(res, "buckets")
    ref = jvc.bucket_real_images_by_cluster(cls_params, CLS_CFG,
                                            d["bucket_images"], 2, batch=2)
    assert sum(len(b) for b in ours) == 5
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o, r)
