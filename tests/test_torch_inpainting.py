"""The port's inpainting module against the JAX package's: ``MaskEncoder``
on the same weights (carried through the npz bridge) at 1e-5, in its pool
and bilinear modes and with the ``target_hw`` resize up (8 → 16, the
``midi_vqgan`` latents) and down; the resize itself against
``jax.image.resize``; the mask generators exactly, seed for seed;
``mask_blending``, ``approx_AL`` and ``algorithm3`` at 1e-5; and
``create_inpainting_triplet`` on the resize codec.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flocoder_torch import inpainting as tinp
from flocoder_torch.models import codecs as tcodecs
from flocoder_torch.models.layers import init_params
from flocoder_torch.training.checkpoint import to_jax_flat
from flocoder_tpu import inpainting as jinp
from flocoder_tpu.models import codecs as jcodecs
from flocoder_tpu.training.checkpoint import unflatten_tree

ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _masks(n=3, size=64, seed=0):
    return np.stack([jinp.generate_mask((size, size), rng=np.random.default_rng(seed + i))
                     for i in range(n)])[..., None]


@pytest.mark.parametrize("mode,target_hw,act", [
    ("pool", None, "sigmoid"), ("pool", (8, 8), "sigmoid"), ("bilinear", (2, 2), "silu"),
    ("pool", (3, 5), "none")])
def test_mask_encoder_matches_jax(mode, target_hw, act):
    """64² masks (4×4 codes before the resize) through both encoders on the
    port's seeded weights."""
    ours = init_params(tinp.MaskEncoder(output_channels=4, mode=mode, final_act=act,
                                        target_hw=target_hw),
                       torch.Generator().manual_seed(3))
    params = unflatten_tree({k: jnp.asarray(v) for k, v in
                             to_jax_flat(ours, {"": "params"}).items()})
    jm = jinp.MaskEncoder(output_channels=4, mode=mode, final_act=act, target_hw=target_hw)
    m = _masks()
    shape = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(m)))
    assert jax.tree_util.tree_structure(shape) == jax.tree_util.tree_structure(params)
    ref = np.asarray(jm.apply(params, jnp.asarray(m)))
    got = ours(torch.from_numpy(m)).detach().numpy()
    assert got.shape == ref.shape == (3, *(target_hw or (4, 4)), 4)
    np.testing.assert_allclose(got, ref, atol=ATOL)


@pytest.mark.parametrize("hw", [(16, 16), (4, 4), (8, 8), (5, 11)])
def test_resize_matches_jax_image_resize(hw):
    x = np.random.default_rng(1).normal(size=(2, 8, 8, 3)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, *hw, 3), "bilinear"))
    np.testing.assert_allclose(tinp.resize_bilinear(torch.from_numpy(x), hw).numpy(), ref,
                               atol=ATOL)


def test_mask_generators_match_seed_for_seed():
    for seed in range(40):
        for kw in ({}, {"mask_type": "brush"}, {"mask_type": "rectangles"},
                   {"mask_type": "noise"}):
            a = tinp.generate_mask((48, 40), rng=np.random.default_rng(seed), **kw)
            b = jinp.generate_mask((48, 40), rng=np.random.default_rng(seed), **kw)
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    for unique in (True, False):
        np.testing.assert_array_equal(
            tinp.generate_mask_batch((32, 32), 6, unique_masks=unique, seed=100003 * 2 + 5),
            jinp.generate_mask_batch((32, 32), 6, unique_masks=unique, seed=100003 * 2 + 5))
    assert tinp.MASK_CHOICES == jinp.MASK_CHOICES and tinp.MASK_PROBS == jinp.MASK_PROBS
    with pytest.raises(ValueError):
        tinp.generate_mask((4, 4), mask_type="circles")


def test_blending_and_research_extras_match_jax():
    rng = np.random.default_rng(2)
    src, noise = (rng.normal(size=(3, 4, 4, 2)).astype(np.float32) for _ in range(2))
    mask = rng.random((3, 4, 4, 2)).astype(np.float32)
    np.testing.assert_allclose(
        tinp.mask_blending(*map(torch.from_numpy, (src, mask, noise))).numpy(),
        np.asarray(jinp.mask_blending(*map(jnp.asarray, (src, mask, noise)))), atol=ATOL)
    target = rng.normal(size=(5, 3, 3, 2)).astype(np.float32)
    source = (target * 0.5 + rng.normal(size=target.shape) * 0.1).astype(np.float32)
    A = tinp.approx_AL(torch.from_numpy(source), torch.from_numpy(target))
    A_ref = np.array(jinp.approx_AL(jnp.asarray(source), jnp.asarray(target)))
    np.testing.assert_allclose(A.numpy(), A_ref, atol=ATOL)
    v, x = (rng.normal(size=(3, 3, 2)).astype(np.float32) for _ in range(2))
    y = rng.normal(size=(18,)).astype(np.float32)
    for tp in (0.3, 0.7):
        ours = tinp.algorithm3(*map(torch.from_numpy, (v, x)), 0.5, tp,
                               torch.from_numpy(y), torch.from_numpy(A_ref))
        ref = jinp.algorithm3(*map(jnp.asarray, (v, x)), 0.5, tp, jnp.asarray(y),
                              jnp.asarray(A_ref))
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=ATOL, atol=ATOL)
    with pytest.raises(ValueError):
        tinp.mask_blending(torch.zeros(1), torch.zeros(1))


def test_inpainting_triplet_matches_jax_on_the_resize_codec():
    """Encode, mask with the seeded batch of masks, encode the masked image:
    both packages give the same latents and masks."""
    img = np.random.default_rng(4).random((3, 32, 32, 3)).astype(np.float32)
    tc = tcodecs.SimpleResizeAE(latent_shape=(8, 8, 3), image_size=32)
    jc = jcodecs.SimpleResizeAE(latent_shape=(8, 8, 3), image_size=32)
    t, m, s = tinp.create_inpainting_triplet(torch.from_numpy(img), tc,
                                             rng=np.random.default_rng(6))
    jt, jm, js = jinp.create_inpainting_triplet(jnp.asarray(img), jc, {},
                                                rng=np.random.default_rng(6))
    np.testing.assert_array_equal(m, jm)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=ATOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=ATOL)
    assert m.shape == (3, 32, 32, 1) and not np.allclose(t.numpy(), s.numpy())
