"""The frozen renderer draws ``testing.simulate_stack``'s scene, and moves
it by the configuration's dither pattern."""

import numpy as np
import torch

from portbench import scene
from subpixal_tpu_torch.testing import simulate_stack

CFG = dict(shape=[160, 192], n_exposures=3, pscale_arcsec=0.05,
           assumed=dict(n_sources=12, psf_amplitude=25.0, psf_sigma_px=1.8,
                        noise=0.01, shift_scale_px=0.5))


def test_planted_shifts_and_frames_match_simulate_stack():
    seed = scene.stack_seed(2 ** 33 + 5, 3)
    st = scene.make_stack(CFG, seed, "cpu")
    exps, planted = simulate_stack(n_exp=3, shape=(160, 192), n_stars=12,
                                   seed=seed, device="cpu")
    np.testing.assert_array_equal(st.planted, np.asarray(planted))
    for e, exp in enumerate(exps):
        got = torch.as_tensor(st.frames[e])
        np.testing.assert_allclose(got.numpy(), exp.data.cpu().numpy(),
                                   rtol=0, atol=2e-6)
        np.testing.assert_allclose(st.crpix[e], exp.wcs.crpix)
        np.testing.assert_allclose(st.cd, exp.wcs.cd)
        np.testing.assert_allclose(st.crval, exp.wcs.crval)


def test_seeds_are_any_whole_number_and_repeat():
    a = scene.stack_seed(2 ** 40 + 17, 0)
    assert a == scene.stack_seed(2 ** 40 + 17, 0)
    assert a != scene.stack_seed(2 ** 40 + 17, 1)
    assert 0 <= a < 2 ** 63
    assert scene.stack_seed(-5, 0) != scene.stack_seed(5, 0)


def test_every_seed_has_the_same_scenes_in_another_order():
    a = scene.make_pool(CFG, 11, 5, "cpu")
    b = scene.make_pool(CFG, 12, 5, "cpu")
    assert [st.index for st in a] != [st.index for st in b]
    assert a[-1].index == b[-1].index == 4
    by_a = {st.index: st for st in a}
    for st in b:
        np.testing.assert_array_equal(st.frames[0], by_a[st.index].frames[0])
        np.testing.assert_array_equal(st.planted, by_a[st.index].planted)


def test_dither_moves_the_stars_and_each_header_records_it():
    box = [[0.0, 0.0], [5.0, 1.5], [2.5, 4.5], [-2.5, 3.0]]
    cfg = dict(CFG, n_exposures=5, dither_offsets_px=box,
               assumed=dict(CFG["assumed"], noise=0.0))
    st = scene.make_stack(cfg, 99, "cpu")
    want = np.array(box + box[:1])
    np.testing.assert_array_equal(st.dither, want)
    np.testing.assert_allclose(st.crpix - st.crpix[0], want)
    a = cfg["assumed"]
    for e, frame in enumerate(st.frames):
        # frame e is the scene with every star moved by its dither point,
        # the frame's planted error on top
        alone = scene.render(st.stars + want[e], st.planted[e:e + 1],
                             cfg["shape"], a["psf_amplitude"],
                             a["psf_sigma_px"], 0.0, 99, "cpu")
        np.testing.assert_array_equal(frame, alone[0].numpy())
    assert not np.array_equal(st.frames[0], st.frames[1])


def test_stars_keep_to_the_configured_box():
    cfg = dict(CFG, assumed=dict(CFG["assumed"],
                                 star_box=[60, 90, 50, 70]))
    st = scene.make_stack(cfg, 5, "cpu")
    assert (st.stars[:, 0] >= 60).all() and (st.stars[:, 0] <= 90).all()
    assert (st.stars[:, 1] >= 50).all() and (st.stars[:, 1] <= 70).all()
