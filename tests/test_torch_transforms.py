"""The port's on-device augmentation (``transoar_tpu_torch/data/transforms``)
against the JAX package's ``transoar_tpu/data/transforms``.

The two draw from different generators (torch against ``jax.random``), so
the operations are compared on fixed matrices, offsets and sigmas:
``affine_resample`` order 1 within atol 1e-5 and order 0 exactly (ties
round to even on both sides), ``gaussian_smooth`` within 1e-5; the whole
``augment_batch`` only where its result does not depend on the draws (every
p = 0, or flips with p = 1). Of the draws, each side's ranges with p = 1 are
checked by one rule."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import one_torch_thread  # noqa: F401
from transoar_tpu.data import transforms as jt
from transoar_tpu_torch.data import transforms as pt


def _aug(**overrides):
    aug = {
        "p_gaussian_noise": 0, "p_gaussian_smooth": 0,
        "p_intensity_scale": 0, "p_intensity_shift": 0,
        "p_adjust_contrast": 0, "p_rotate": 0, "p_zoom": 0, "p_shear": 0,
        "p_translate": 0, "p_flip": 0,
        "gaussian_noise_mean": 0.0, "gaussian_noise_std": 0.1,
        "gaussian_smooth_sigma": [0.5, 1.0],
        "intensity_scale_factors": 0.1, "intensity_shift_offsets": 0.1,
        "adjust_contrast_gamma": [0.7, 1.5],
        "rotation": [-5, 5], "min_zoom": 0.9, "max_zoom": 1.1,
        "translate_percentage": 10, "shear_range": [0.1, 0.2, 0.3],
        "flip_axis": [0, 1, 2],
    }
    aug.update(overrides)
    return aug


_ROT = np.array([[0.98, 0.10, -0.05], [-0.08, 1.02, 0.03],
                 [0.04, -0.02, 0.95]])
AFFINES = {
    "rotation_shear_zoom": (_ROT, [0.7, -1.3, 0.4]),
    "half_voxel_ties": (np.diag([0.5, 2.0, 1.0]), [0.25, -3.5, 0.5]),
    "flip_all": (-np.eye(3), [15.0, 11.0, 7.0]),
    "integer_shift": (np.eye(3), [-1.0, 2.0, 0.0]),
    "sampled": jt.sample_affine_np(np.random.default_rng(4), (16, 12, 8),
                                   _aug(p_rotate=1, p_zoom=1, p_shear=1,
                                        p_translate=1, rotation=[-30, 30])),
}


@pytest.fixture
def volumes(rng):
    image = rng.normal(size=(16, 12, 8)).astype(np.float32)
    label = rng.integers(0, 5, size=(16, 12, 8)).astype(np.int32)
    return image, label


@pytest.mark.parametrize("name", sorted(AFFINES))
def test_affine_resample_matches_jax(volumes, name):
    matrix, offset = (np.asarray(a, np.float32) for a in AFFINES[name])
    for vol, order in zip(volumes, (1, 0)):
        ref = np.asarray(jt.affine_resample(jnp.asarray(vol),
                                            jnp.asarray(matrix),
                                            jnp.asarray(offset), order))
        ours = pt.affine_resample(torch.from_numpy(vol),
                                  torch.from_numpy(matrix),
                                  torch.from_numpy(offset), order).numpy()
        assert ours.dtype == ref.dtype
        if order == 0:
            np.testing.assert_array_equal(ours, ref)
        else:
            np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("sigmas,radius", [((0.8, 0.6, 1.0), 4),
                                           ((0.5, 0.5, 0.5), 2),
                                           ((1.0, 0.7, 0.9), 4)])
def test_gaussian_smooth_matches_jax(volumes, sigmas, radius):
    image = volumes[0][..., None]  # [S0, S1, S2, 1], as the step has it
    s = np.asarray(sigmas, np.float32)
    ref = jt.gaussian_smooth(jnp.asarray(image), jnp.asarray(s), radius)
    ours = pt.gaussian_smooth(torch.from_numpy(image), torch.from_numpy(s),
                              radius)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)


def test_window_matches_jax(volumes):
    stats = {"percentile_00_5": -0.8, "percentile_99_5": 1.2}
    np.testing.assert_allclose(
        pt.eval_transform(torch.from_numpy(volumes[0]), stats).numpy(),
        np.asarray(jt.eval_transform(jnp.asarray(volumes[0]), stats)),
        rtol=0, atol=1e-7)


def _both_batches(volumes, aug, stats=None):
    image, label = volumes
    images, labels = image[None, ..., None], label[None]
    ref = jt.augment_batch(jnp.asarray(images), jnp.asarray(labels),
                           jax.random.key(0), aug, intensity_stats=stats)
    ours = pt.augment_batch(torch.from_numpy(images),
                            torch.from_numpy(labels),
                            torch.Generator().manual_seed(0), aug,
                            intensity_stats=stats)
    return ([np.asarray(r) for r in ref], [o.numpy() for o in ours],
            images, labels)


def test_identity_when_every_p_is_zero(volumes):
    ref, ours, images, labels = _both_batches(volumes, _aug())
    np.testing.assert_allclose(ours[0], images, atol=1e-5)
    np.testing.assert_array_equal(ours[1], labels)
    np.testing.assert_allclose(ours[0], ref[0], atol=1e-5)
    np.testing.assert_array_equal(ours[1], ref[1])


def test_flips_are_exact(volumes):
    stats = {"percentile_00_5": -1.0, "percentile_99_5": 1.0}
    ref, ours, images, labels = _both_batches(volumes, _aug(p_flip=1.0),
                                              stats)
    flipped = np.clip((images[0, ::-1, ::-1, ::-1] + 1.0) / 2.0, 0, 1)
    np.testing.assert_array_equal(ours[0][0], flipped)
    np.testing.assert_array_equal(ours[1][0], labels[0, ::-1, ::-1, ::-1])
    np.testing.assert_allclose(ours[0], ref[0], atol=1e-5)
    np.testing.assert_array_equal(ours[1], ref[1])


SHAPE = (16, 12, 8)


def _draws(side, aug, n=12):
    """n affines (matrix, offset) as float64 numpy from either side."""
    out = []
    for i in range(n):
        if side == "jax":
            m, o = jt.sample_affine(jax.random.key(i), SHAPE, aug)
        else:
            m, o = pt.sample_affine(torch.Generator().manual_seed(i), SHAPE,
                                    aug)
        out.append((np.asarray(m, np.float64), np.asarray(o, np.float64)))
    return out


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_sampler_ranges_with_p_one(side):
    center = (np.asarray(SHAPE) - 1.0) / 2.0
    aug = _aug()
    for m, o in _draws(side, aug):  # p = 0: the identity
        np.testing.assert_allclose(m, np.eye(3), atol=1e-6)
        np.testing.assert_allclose(o, 0.0, atol=1e-5)
    zooms = []
    for m, o in _draws(side, _aug(p_zoom=1.0)):
        np.testing.assert_allclose(m, np.diag(np.diag(m)), atol=1e-7)
        zooms.extend(1.0 / np.diag(m))
        np.testing.assert_allclose(o, center - m @ center, atol=1e-5)
    assert 0.9 - 1e-6 <= min(zooms) < max(zooms) <= 1.1 + 1e-6
    t = np.asarray(SHAPE) * 0.1
    shifts = []
    for m, o in _draws(side, _aug(p_translate=1.0)):
        np.testing.assert_allclose(m, np.eye(3), atol=1e-7)
        shifts.append(-o)
    assert (np.abs(shifts) <= t + 1e-5).all()
    assert np.ptp(shifts, axis=0).min() > 0
    for m, o in _draws(side, _aug(p_shear=1.0)):
        np.testing.assert_allclose(np.diag(m), 1.0, atol=1e-7)
        np.testing.assert_allclose(np.tril(m, -1), 0.0, atol=1e-7)
        assert (np.abs(m[[0, 0, 1], [1, 2, 2]])
                <= np.array([0.1, 0.2, 0.3]) + 1e-6).all()
    for m, o in _draws(side, _aug(p_flip=1.0)):
        np.testing.assert_allclose(m, -np.eye(3), atol=1e-7)
    for m, o in _draws(side, _aug(p_rotate=1.0, rotation=[-20, 20])):
        np.testing.assert_allclose(m @ m.T, np.eye(3), atol=1e-5)
        # R = Rz(c) Ry(b) Rx(a)
        b = -math.asin(m[2, 0])
        a = math.atan2(m[2, 1], m[2, 2])
        c = math.atan2(m[1, 0], m[0, 0])
        assert max(abs(a), abs(b), abs(c)) <= math.radians(20) + 1e-5
        np.testing.assert_allclose(o, center - m @ center, atol=1e-4)


def _intensity(side, aug, image, seed):
    if side == "jax":
        return np.asarray(jt.intensity_augment(jax.random.key(seed),
                                               jnp.asarray(image), aug))
    return pt.intensity_augment(torch.Generator().manual_seed(seed),
                                torch.from_numpy(image), aug).numpy()


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_intensity_ranges_with_p_one(side, rng):
    flat = np.full((8, 8, 4, 1), 0.5, np.float32)
    image = rng.uniform(size=(8, 8, 4, 1)).astype(np.float32)
    image.flat[0], image.flat[1] = 0.0, 1.0  # range exactly [0, 1]
    scales, shifts, gammas = [], [], []
    for seed in range(12):
        out = _intensity(side, _aug(p_intensity_scale=1.0), flat, seed)
        assert np.ptp(out) == 0
        scales.append(out.flat[0] / 0.5 - 1.0)
        out = _intensity(side, _aug(p_intensity_shift=1.0), flat, seed)
        shifts.append(out.flat[0] - 0.5)
        out = _intensity(side, _aug(p_adjust_contrast=1.0), image, seed)
        mid = np.abs(image - 0.5) < 0.3
        gamma = np.log(out[mid]) / np.log(image[mid])
        assert np.ptp(gamma) < 1e-3
        gammas.append(gamma.mean())
        out = _intensity(side, _aug(p_gaussian_noise=1.0,
                                    gaussian_noise_std=0.2), flat, seed)
        assert 0.1 < (out - 0.5).std() < 0.3
        out = _intensity(side, _aug(p_gaussian_smooth=1.0), image, seed)
        tv = np.abs(np.diff(out[..., 0], axis=0)).mean()
        assert tv < 0.8 * np.abs(np.diff(image[..., 0], axis=0)).mean()
    for draws, lo, hi in ((scales, -0.1, 0.1), (shifts, -0.1, 0.1),
                          (gammas, 0.7, 1.5)):
        assert lo - 1e-5 <= min(draws) < max(draws) <= hi + 1e-5


@pytest.mark.parametrize("ahead,pulled", [(0, 1), (2, 2), (4, 3)])
def test_host_loader_keeps_cases_in_flight(ahead, pulled):
    """When the first batch is handed out, the host augmenter has pulled
    as many later batches as ``ahead`` cases need (0: none, the JAX
    package's design), and every case is augmented once."""
    rng = np.random.default_rng(0)
    batches, seen = [], []
    for step in range(3):
        batches.append({"image": rng.normal(size=(2, 8, 6, 4, 1))
                        .astype(np.float32),
                        "seg": np.zeros((2, 8, 6, 4), np.int32),
                        "index": np.array([2 * step, 2 * step + 1])})

    class Source:
        def __len__(self):
            return len(batches)

        def __iter__(self):
            for batch in batches:
                seen.append(batch)
                yield batch

    loader = pt.HostAugmentingLoader(Source(), _aug(p_rotate=1.0),
                                     workers=2, ahead=ahead)
    it = iter(loader)
    first = next(it)
    assert len(seen) == pulled
    rest = list(it)
    assert len(rest) == 2 and len(loader.case_ms) == 6
    for step, (out, batch) in enumerate(zip([first, *rest], batches)):
        np.testing.assert_array_equal(out["index"], batch["index"])
        for row, case in enumerate(batch["index"]):
            # seed 0, epoch 0: the case's seed is step * 101 + its index
            ref = pt.augment_case_np(batch["image"][row], batch["seg"][row],
                                     step * 101 + int(case),
                                     _aug(p_rotate=1.0))
            np.testing.assert_array_equal(out["image"][row], ref[0])
