"""The port's point functions (models/stn.py: _invert_similarity, the
single STN's stn_congeal_points, stn_uncongeal_points and
stn_transfer_points, the composed STN's composed_congeal_points,
composed_transfer_points and composed_match_flows) against the JAX
package's, on the CPU.

The STN is the one of tests/test_ar_apps.py (S=64) with noise 0.2 on its
weights (tests/test_torch_ar.py), so that both heads warp and every flip
case of the 4-way match occurs: the seeded pairs below pick 0, 1, 2 and 3.
Tolerances: points within 1e-3 px (the grids agree within 1e-4 in [-1, 1]
units); flip picks and permuted points equal. The flow head's inversion
picks, for each point, the texel of its grid nearest to it through
|p|^2 + |g|^2 - 2 <g, p>, a form that cancels: where the port picks
another texel than JAX, the pick counts as correct only if the JAX
package's own distances at the two texels differ by under 1e-5 relative.
Such picks are counted and printed, and their points are left out of the
1e-3 px comparison (a texel apart is a whole pixel).
"""

from importlib import import_module

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gangealing_torch.models import stn as tstn

from test_torch_ar import ARCH, ar_images, ar_model, ar_params

jstn = import_module("gangealing_tpu.models.stn")

S = 64
JCFG = jstn.ComposedSTNConfig(**ARCH)
PT_TOL = 1e-3
TIE_REL = 1e-5
PERM = np.array([1, 0, 2, 4, 3])


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


def _pairs(n=4):
    """Image pairs whose 4-way match picks 0, 1, 2 and 3 in turn, and
    seeded key points in pixels."""
    rng = np.random.RandomState(3)
    kps = [(rng.rand(n, 5, 2) * (S - 1)).astype(np.float32)
           for _ in range(2)]
    return ar_images(32, n), ar_images(132, n), kps[0], kps[1]


def _t(a):
    return torch.from_numpy(np.array(a))


def near_tie_picks(grid, points, ours, ref):
    """Where the port's inversion picked another texel than JAX's: assert
    that the JAX package's own distances (float32, its formula) at the two
    texels differ by under TIE_REL relative, and return the mask of those
    points. grid: the reference's (N, H, W, 2) grid; points: the
    normalized (N, P, 2) points it inverted; ours, ref: (N, P, 2) texels."""
    grid, points = np.asarray(grid, np.float32), np.asarray(points,
                                                            np.float32)
    ours, ref = np.asarray(ours), np.asarray(ref)
    differ = (ours != ref).any(-1)
    N, H, W, _ = grid.shape
    g = grid.reshape(N, H * W, 2)
    # the inputs are those JAX inverted: its picks are its distances' minima
    d_all = ((points ** 2).sum(-1)[:, None, :] + (g ** 2).sum(-1)[:, :, None]
             - 2 * np.einsum("nhc,npc->nhp", g, points))
    d_ref = np.take_along_axis(
        d_all, (ref[..., 1] * W + ref[..., 0]).astype(int)[:, None], 1)[:, 0]
    d_min = d_all.min(1)
    assert (d_ref - d_min <= TIE_REL * np.abs(d_min)
            + np.finfo(np.float32).tiny).all()
    for n, p in zip(*np.nonzero(differ)):
        pt = points[n, p]

        def dist(xy):
            gv = g[n, int(xy[1]) * W + int(xy[0])]
            return (pt @ pt + gv @ gv) - 2 * (gv @ pt)

        d_ours, d_ref = dist(ours[n, p]), dist(ref[n, p])
        scale = max(abs(d_ours), abs(d_ref), np.finfo(np.float32).tiny)
        assert abs(d_ours - d_ref) <= TIE_REL * scale, (
            f"point {n},{p}: picked {ours[n, p]} against {ref[n, p]}, "
            f"distances {d_ours} and {d_ref}")
    return differ


def _close(ours, ref, skip=None, tol=PT_TOL):
    ours, ref = np.asarray(ours), np.asarray(ref)
    keep = ~skip if skip is not None else np.ones(ref.shape[:-1], bool)
    np.testing.assert_allclose(ours[keep], ref[keep], atol=tol, rtol=0)


def test_invert_similarity_matches_jax():
    rng = np.random.RandomState(4)
    m = (np.eye(2, 3) + 0.3 * rng.randn(6, 2, 3)).astype(np.float32)
    np.testing.assert_allclose(tstn._invert_similarity(_t(m)).numpy(),
                               np.asarray(jstn._invert_similarity(
                                   jnp.asarray(m))), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("stage", [0, 1])
def test_single_stn_points_match_jax(model, jparams, stage):
    """stn_congeal_points, stn_uncongeal_points and stn_transfer_points of
    the similarity STN (stage 0) and of the flow STN (stage 1) alone."""
    imgsA, imgsB, kpsA, _ = _pairs()
    stn = model.stns[stage]
    jcfg = JCFG.stn_cfgs[stage]
    jp = jstn.params_view(jparams, f"stns.{stage}")
    A, B, P = jnp.asarray(imgsA), jnp.asarray(imgsB), jnp.asarray(kpsA)
    with torch.no_grad():
        _, _, ours = tstn.stn_congeal_points(stn, _t(imgsA), _t(kpsA),
                                             return_full=True)
    _, fom, ref = jstn.stn_congeal_points(jp, jcfg, A, P, return_full=True)
    ties = None
    if stage == 1:
        ident = np.asarray(jstn.identity_grid(1, fom.shape[1],
                                              fom.shape[2]))
        pts = np.asarray(jstn.normalize_points(P, S, S))
        ties = near_tie_picks(np.asarray(fom) + ident, pts, ours.numpy(),
                              ref)
        print(f"stage 1 congeal: {int(ties.sum())} near-tie picks of "
              f"{ties.size}")
    _close(ours.numpy(), ref, ties)
    cong = np.asarray(ref)
    for kw in (dict(), dict(normalize_input_points=True,
                            unnormalize_output_points=False)):
        with torch.no_grad():
            got = tstn.stn_uncongeal_points(stn, _t(imgsB), _t(cong), **kw)
        _close(got.numpy(), jstn.stn_uncongeal_points(
            jp, jcfg, B, jnp.asarray(cong), **kw))
    with torch.no_grad():
        got = tstn.stn_transfer_points(stn, _t(imgsA), _t(imgsB), _t(kpsA))
    _close(got.numpy(), jstn.stn_transfer_points(jp, jcfg, A, B, P), ties)


def _composed_nn_inputs(jparams, imgsA, kpsA):
    """The grid and the normalized points the JAX package's composed
    congeal inverts in its flow stage."""
    A = jnp.asarray(imgsA)
    view = jstn.params_view(jparams, "stns.0")
    out0, warp, cong0 = jstn.stn_congeal_points(
        view, JCFG.stn_cfgs[0], A, jnp.asarray(kpsA),
        unnormalize_output_points=True, output_resolution=JCFG.flow_size,
        input_img_for_sampling=A, return_full=True)
    _, fom, _ = jstn.stn_congeal_points(
        jstn.params_view(jparams, "stns.1"), JCFG.stn_cfgs[1], out0, cong0,
        base_warp=warp, input_img_for_sampling=A, return_full=True)
    ident = np.asarray(jstn.identity_grid(1, fom.shape[1], fom.shape[2]))
    return np.asarray(fom) + ident, np.asarray(
        jstn.normalize_points(cong0, S, S))


def test_composed_congeal_and_transfer_points_match_jax(model, jparams):
    imgsA, imgsB, kpsA, _ = _pairs()
    A, B, P = (jnp.asarray(a) for a in (imgsA, imgsB, kpsA))
    with torch.no_grad():
        ours = tstn.composed_congeal_points(model, _t(imgsA), _t(kpsA))
        moved = tstn.composed_transfer_points(model, _t(imgsA), _t(imgsB),
                                              _t(kpsA))
    ref = jstn.composed_congeal_points(jparams, JCFG, A, P)
    ties = near_tie_picks(*_composed_nn_inputs(jparams, imgsA, kpsA),
                          ours.numpy(), ref)
    print(f"composed congeal: {int(ties.sum())} near-tie picks of "
          f"{ties.size}")
    _close(ours.numpy(), ref, ties)
    _close(moved.numpy(), jstn.composed_transfer_points(jparams, JCFG, A, B,
                                                        P), ties)


@pytest.mark.parametrize("permutation", [None, PERM])
@pytest.mark.parametrize("with_b", [True, False])
def test_composed_match_flows_matches_jax(model, jparams, permutation,
                                          with_b):
    """Every flip case (picks 0, 1, 2, 3), with and without a key point
    permutation, with and without pointsB: equal picks, images and
    points, the permutation applied once per mirrored image of the pair
    as the JAX package applies it."""
    imgsA, imgsB, kpsA, kpsB = _pairs()
    args = [imgsA, imgsB, kpsA] + ([kpsB] if with_b else [])
    with torch.no_grad():
        ours = tstn.composed_match_flows(model, *map(_t, args),
                                         permutation=permutation)
    ref = jstn.composed_match_flows(jparams, JCFG, *map(jnp.asarray, args),
                                    permutation=permutation)
    assert ours[-1].ravel().tolist() == [0, 1, 2, 3]
    assert len(ours) == len(ref) == (5 if with_b else 4)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_match_flows_takes_the_first_of_tied_sums():
    """An identity-initialised STN gives every image the same flow, so all
    four sums tie: both packages pick 0 and mirror nothing."""
    import jax
    init = jstn.composed_stn_init(jax.random.PRNGKey(0), JCFG)
    model = ar_model({k: np.asarray(v) for k, v in init.items()})
    imgsA, imgsB, kpsA, kpsB = _pairs()
    with torch.no_grad():
        ours = tstn.composed_match_flows(model, _t(imgsA), _t(imgsB),
                                         _t(kpsA), _t(kpsB),
                                         permutation=PERM)
    ref = jstn.composed_match_flows(init, JCFG,
                                    *map(jnp.asarray, (imgsA, imgsB, kpsA,
                                                       kpsB)),
                                    permutation=PERM)
    assert ours[-1].ravel().tolist() == [0] * 4
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
