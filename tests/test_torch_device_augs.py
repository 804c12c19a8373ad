"""The port's device augmentation (flocoder_torch.data.device_augs) against
the JAX package's ``make_device_augment``.

JAX's threefry and torch's Philox cannot draw alike, so the test draws
JAX's per-sample parameters from ``jax.random.split`` exactly as
``flocoder_tpu/data/device_augs.py`` does (a key per sample, split into
angle, scale, ratio, x, y and flip keys) and injects them into the port's
``warp``: the output holds against ``make_device_augment`` within 1e-5 at
B=8, S=32, S0=40 (fp32; the bilinear taps are the same arithmetic, the
rotation's cosine and sine may differ by an ulp). The identity
configuration is a plain copy, the flip case is the mirror, the corners of
a rotation are black, the port's own draws keep the laws (ranges, a flip
rate near 0.5, the same output for the same generator seed), and
``load_resized`` equals JAX's.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from flocoder_torch.data import device_augs as td
from flocoder_tpu.data import device_augs as jd

B, S, S0 = 8, 32, 40


def _imgs(b=B, s0=S0, seed=0):
    return np.random.default_rng(seed).random((b, s0, s0, 3)).astype(np.float32)


def _jax_draws(key, b, rotate_deg=15.0, rrc_scale=(0.8, 1.0), rrc_ratio=(3 / 4, 4 / 3),
               hflip=0.5) -> td.AugParams:
    """The per-sample draws of ``make_device_augment``'s ``fn(images, key)``."""
    out = {k: [] for k in td.AugParams._fields}
    for k in jax.random.split(key, b):
        k_th, k_sc, k_ar, k_x, k_y, k_fl = jax.random.split(k, 6)
        out["angle"].append(jax.random.uniform(k_th, (), minval=-rotate_deg,
                                               maxval=rotate_deg))
        out["scale"].append(jax.random.uniform(k_sc, (), minval=rrc_scale[0],
                                               maxval=rrc_scale[1]))
        out["ratio"].append(jax.random.uniform(k_ar, (), minval=rrc_ratio[0],
                                               maxval=rrc_ratio[1]))
        out["x"].append(jax.random.uniform(k_x, ()))
        out["y"].append(jax.random.uniform(k_y, ()))
        out["flip"].append(jax.random.uniform(k_fl, ()) < hflip)
    return td.AugParams(**{k: torch.from_numpy(np.array(v)) for k, v in out.items()})


@pytest.mark.parametrize("seed", [0, 1])
def test_warp_with_jax_draws_matches_jax(seed):
    x = _imgs(seed=seed)
    key = jax.random.PRNGKey(seed)
    ref = np.asarray(jd.make_device_augment(S, src_size=S0)(jnp.asarray(x), key))
    params = _jax_draws(key, B)
    assert 0 < int(params.flip.sum()) < B or seed != 0     # both branches are exercised
    got = td.warp(torch.from_numpy(x), params, S).numpy()
    assert got.shape == ref.shape == (B, S, S, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("hflip", [0.0, 1.0], ids=["identity", "flip"])
def test_identity_and_flip_configurations(hflip):
    aug = td.make_device_augment(S, src_size=S, rotate_deg=0.0, center_crop=1.0,
                                 rrc_scale=(1.0, 1.0), rrc_ratio=(1.0, 1.0), hflip=hflip)
    x = _imgs(2, S)
    out = aug(torch.from_numpy(x), torch.Generator().manual_seed(0)).numpy()
    want = x[:, :, ::-1] if hflip else x
    np.testing.assert_allclose(out, (want - 0.5) / 0.5, rtol=0, atol=1e-5)


def test_rotation_corners_are_black():
    """A 45° turn of the whole frame leaves the output's corners outside the
    source: zero before the normalisation, so −1 after."""
    x = np.ones((1, S, S, 3), np.float32)
    p = td.AugParams(angle=torch.tensor([45.0]), scale=torch.tensor([1.0]),
                     ratio=torch.tensor([1.0]), x=torch.tensor([0.0]), y=torch.tensor([0.0]),
                     flip=torch.tensor([False]))
    out = td.warp(torch.from_numpy(x), p, S, center_crop=1.0).numpy()[0]
    for r, c in ((0, 0), (0, S - 1), (S - 1, 0), (S - 1, S - 1)):
        np.testing.assert_array_equal(out[r, c], -1.0)
    np.testing.assert_array_equal(out[S // 2, S // 2], 1.0)


def test_own_draws_keep_the_laws():
    n = 4000
    p = td.draw_params(n, torch.Generator().manual_seed(0))
    assert p.angle.min() >= -15 and p.angle.max() <= 15
    assert p.scale.min() >= 0.8 and p.scale.max() <= 1.0
    assert p.ratio.min() >= 3 / 4 and p.ratio.max() <= 4 / 3
    assert p.x.min() >= 0 and p.x.max() < 1 and p.y.min() >= 0 and p.y.max() < 1
    assert abs(float(p.flip.float().mean()) - 0.5) < 0.03
    assert abs(float(p.angle.mean())) < 0.5 and abs(float(p.x.mean()) - 0.5) < 0.02
    aug = td.make_device_augment(S, src_size=S0)
    x = torch.from_numpy(_imgs())
    o1 = aug(x, torch.Generator().manual_seed(3))
    o2 = aug(x, torch.Generator().manual_seed(3))
    o3 = aug(x, torch.Generator().manual_seed(4))
    assert torch.equal(o1, o2) and float((o1 - o3).abs().max()) > 1e-3
    assert float(o1.min()) >= -1 - 1e-6 and float(o1.max()) <= 1 + 1e-6
    with pytest.raises(ValueError, match="40"):
        aug(x[:, :32, :32], torch.Generator())


def test_load_resized_equals_jax():
    rng = np.random.default_rng(5)
    for size, mode in (((50, 70), "RGB"), ((64, 64), "L"), ((30, 30), "RGBA")):
        arr = rng.integers(0, 256, size + ((len(mode),) if mode != "L" else ()), np.uint8)
        img = Image.fromarray(arr, mode)
        got = td.load_resized(img, S0)
        np.testing.assert_array_equal(got, jd.load_resized(img, S0))
        assert got.shape == (S0, S0, 3) and got.dtype == np.float32
    assert td.default_src_size(128) == jd.default_src_size(128) == 160
    assert td.default_src_size(S) == math.ceil(1.25 * S)
