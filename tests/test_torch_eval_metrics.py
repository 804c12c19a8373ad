"""The port's evaluation core (flocoder_torch.ops.fid, metrics'
``compute_sample_metrics``, evaluation's ``evaluate_model``) against the JAX
package's on the same numpy inputs.

The FID tests take the rp features at 256 dimensions (the same function as
the default rp2048, whose features are held to JAX's separately): a
2048-wide Newton–Schulz root costs tens of seconds on one CPU thread.

Tolerances: the rp2048 projection matrix bit for bit; the antialiased
resize weights 1e-6; the rp2048 features 1e-5; the Newton–Schulz square
root and the Fréchet distance 1e-4 relative; every key of
``compute_sample_metrics`` and of ``evaluate_model`` 1e-4 relative (plus
1e-5 absolute), and the evaluation's sampled latents 1e-4.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flocoder_tpu import evaluation as jeval
from flocoder_tpu import metrics as jmetrics
from flocoder_tpu.models import codecs as jcodecs
from flocoder_tpu.ops import fid as jfid
from flocoder_torch import evaluation as teval
from flocoder_torch import metrics as tmetrics
from flocoder_torch.models import codecs as tcodecs
from flocoder_torch.ops import fid as tfid


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per xdist worker keeps these tests quick."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _images(seed, n=12, s=32, c=3, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, (n, s, s, c)).astype(np.float32)


@pytest.mark.parametrize("in_dim,out_dim,seed", [(84 * 3, 2048, 0), (84, 64, 5)])
def test_projection_matrix_is_the_jax_matrix_bit_for_bit(in_dim, out_dim, seed):
    ours = tfid._projection_matrix(in_dim, out_dim, seed)
    ref = np.asarray(jfid._projection_matrix(in_dim, out_dim, seed))
    assert ours.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("in_size", [128, 32, 17, 8, 5])
@pytest.mark.parametrize("out_size", [8, 4, 2])
def test_resize_weights_match_jax(in_size, out_size):
    from jax._src.image.scale import _kernels, ResizeMethod, compute_weight_mat
    ref = np.asarray(compute_weight_mat(in_size, out_size, out_size / in_size, 0.0,
                                        _kernels[ResizeMethod.LINEAR], True))
    np.testing.assert_allclose(tfid.resize_weights(in_size, out_size), ref, atol=1e-6)
    # and the pooling they define is jax.image.resize's
    x = _images(in_size + out_size, n=2, s=in_size)
    ours = torch.einsum("bhwc,hi,wj->bijc", torch.from_numpy(x),
                        torch.from_numpy(tfid.resize_weights(in_size, out_size)),
                        torch.from_numpy(tfid.resize_weights(in_size, out_size)))
    ref = jax.image.resize(jnp.asarray(x), (2, out_size, out_size, 3), "linear")
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("kind", ["uint8", "float", "gray"])
def test_rp2048_features_match_jax(kind):
    x = _images(1, c=1 if kind == "gray" else 3, lo=-1.2, hi=1.2)
    if kind == "uint8":
        x = ((x + 1.2) / 2.4 * 255).astype(np.uint8)
    ours = tfid.make_random_projection_features()(torch.from_numpy(x))
    ref = jfid.make_random_projection_features()(jnp.asarray(x))
    assert ours.shape == (12, 2048)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)
    with pytest.warns(UserWarning, match="0-255"):
        tfid.make_random_projection_features()(torch.from_numpy(x.astype(np.float32) * 200))


def test_sqrtm_and_frechet_distance_match_jax():
    rng = np.random.default_rng(2)
    a = rng.normal(size=(40, 16)).astype(np.float32)
    b = (rng.normal(size=(40, 16)) * 1.3 + 0.2).astype(np.float32)
    A = (a.T @ a / 40).astype(np.float32)
    np.testing.assert_allclose(tfid.sqrtm_newton_schulz(torch.from_numpy(A)).numpy(),
                               np.asarray(jfid.sqrtm_newton_schulz(jnp.asarray(A))),
                               rtol=1e-4, atol=1e-5)
    (m1, c1), (m2, c2) = tfid._stats(torch.from_numpy(a)), tfid._stats(torch.from_numpy(b))
    (j1, k1), (j2, k2) = jfid._stats(jnp.asarray(a)), jfid._stats(jnp.asarray(b))
    for eps_rel in (1e-3, 0.0):
        np.testing.assert_allclose(float(tfid.frechet_distance(m1, c1, m2, c2, eps_rel)),
                                   float(jfid.frechet_distance(j1, k1, j2, k2, eps_rel)),
                                   rtol=1e-4)


def _rp256():
    return (tfid.make_random_projection_features(dim=256),
            jfid.make_random_projection_features(dim=256))


def test_fid_score_and_chunked_match_jax():
    real = ((_images(3, n=20) + 1) * 127.5).astype(np.uint8)
    fake = ((_images(4, n=20) * 0.5 + 1) * 127.5).astype(np.uint8)
    tf, jf = _rp256()
    ref = float(jfid.fid_score(jnp.asarray(real), jnp.asarray(fake), feature_fn=jf))
    ours = float(tfid.fid_score(torch.from_numpy(real), torch.from_numpy(fake),
                                feature_fn=tf))
    np.testing.assert_allclose(ours, ref, rtol=1e-4)
    chunked = float(tfid.fid_score_chunked(torch.from_numpy(real), torch.from_numpy(fake),
                                           feature_fn=tf, chunk_size=7))
    np.testing.assert_allclose(chunked, ours, rtol=1e-5)
    assert tfid.feature_backend_name(None) == jfid.feature_backend_name(None) == "rp2048"


def test_default_feature_fn_refuses_the_inception_weights(tmp_path, monkeypatch):
    """Without ``weights/fid_inception.npz`` both packages default to rp2048;
    with it (a seeded random init the port writes in the JAX flat layout),
    both pick the Inception features, stamped ``fid_inception``. (The name is
    from when the port refused the file.)"""
    from flocoder_torch.models.inception import InceptionV3Features, save_inception_weights
    from flocoder_torch.models.layers import init_params
    monkeypatch.chdir(tmp_path)
    assert tfid.default_feature_fn().backend_name == "rp2048"
    save_inception_weights(init_params(InceptionV3Features(), torch.Generator().manual_seed(0)),
                           "weights/fid_inception.npz")
    assert tfid.default_feature_fn().backend_name == "fid_inception"
    assert tfid.feature_backend_name(None) == jfid.feature_backend_name(None) == "fid_inception"


def _assert_metrics(ours: dict, ref: dict):
    assert set(ours) == set(ref), (sorted(ours), sorted(ref))
    for k, v in ref.items():
        if isinstance(v, str):
            assert ours[k] == v, k
        else:
            np.testing.assert_allclose(float(ours[k]), float(v), rtol=1e-4, atol=1e-5,
                                       err_msg=k)


def test_compute_sample_metrics_matches_jax_key_by_key():
    rng = np.random.default_rng(5)
    pl = rng.normal(size=(16, 4, 4, 3)).astype(np.float32)
    tl = (rng.normal(size=(18, 4, 4, 3)) * 0.8).astype(np.float32)
    dp = _images(6, n=16, lo=-1.5, hi=2.5)
    dt = _images(7, n=16)
    tf, jf = _rp256()
    ref = jmetrics.compute_sample_metrics(*(jnp.asarray(a) for a in (pl, tl, dp, dt)),
                                          feature_fn=jf)
    ours = tmetrics.compute_sample_metrics(*(torch.from_numpy(a) for a in (pl, tl, dp, dt)),
                                           feature_fn=tf)
    _assert_metrics(ours, ref)
    np.testing.assert_array_equal(tmetrics.to_uint8(torch.from_numpy(dp)).numpy(),
                                  np.asarray(jmetrics.to_uint8(jnp.asarray(dp))))
    np.testing.assert_allclose(
        tmetrics.normalize_recon(torch.from_numpy(dt), torch.from_numpy(dp)).numpy(),
        np.asarray(jmetrics.normalize_recon(jnp.asarray(dt), jnp.asarray(dp))), atol=1e-6)


def _field(xp):
    def apply_fn(x, t, cond):
        v = -x * (1.0 + t[:, None, None, None] / 999.0)
        cc = cond["class_cond"]
        return v + xp.where(cc >= 0, cc + 1.0, 0.0 * cc)[:, None, None, None] * 0.1
    return apply_fn


def test_evaluate_model_on_the_resize_codec_matches_jax(tmp_path):
    """RK4 + CFG on an analytic field from the same source noise, decoded by
    the resize codec (8×8×3 latents → 32² images): every metric key, and
    the same grids written; then the same with inpainting masks."""
    rng = np.random.default_rng(8)
    target = rng.normal(size=(12, 8, 8, 3)).astype(np.float32)
    source = rng.normal(size=(10, 8, 8, 3)).astype(np.float32)
    cc = rng.integers(0, 3, 12).astype(np.int32)
    kw = dict(epoch=3, batch_size=10, n_classes=3, method="rk4", n_steps=5,
              cfg_strength=2.0, tag="ema_")
    tf, jf = _rp256()
    jcodec = jcodecs.SimpleResizeAE(latent_shape=(8, 8, 3), image_size=32)
    ref = jeval.evaluate_model(
        _field(jnp), jcodec, {}, target_latents=jnp.asarray(target),
        rng=jax.random.PRNGKey(0), cond={"class_cond": jnp.asarray(cc)},
        source=jnp.asarray(source), use_wandb=False, output_dir=str(tmp_path / "jax"),
        feature_fn=jf, **kw)
    marks = []
    ours = teval.evaluate_model(
        _field(torch), tcodecs.SimpleResizeAE(latent_shape=(8, 8, 3), image_size=32),
        target_latents=torch.from_numpy(target), generator=torch.Generator(),
        cond={"class_cond": torch.from_numpy(cc).long()}, source=torch.from_numpy(source),
        output_dir=str(tmp_path / "torch"), mark=marks.append, feature_fn=tf, **kw)
    _assert_metrics(ours, ref)
    assert marks == ["sampler", "decode", "metrics", "grids"]
    assert sorted(os.listdir(tmp_path / "torch")) == sorted(os.listdir(tmp_path / "jax"))
    assert "ema_decoded_pred_rk4_16_epoch3.png" in os.listdir(tmp_path / "torch")
    # an inpainting evaluation: latent masks ride in cond (doubled under CFG)
    # and the pixel masks come along; both packages write their grids
    mask = rng.random((12, 8, 8, 3)).astype(np.float32)
    mpx = (rng.random((12, 32, 32, 1)) > 0.5).astype(np.float32)
    ref = jeval.evaluate_model(
        _field(jnp), jcodec, {}, target_latents=jnp.asarray(target),
        rng=jax.random.PRNGKey(0),
        cond={"class_cond": jnp.asarray(cc), "mask_cond": jnp.asarray(mask)},
        source=jnp.asarray(source), mask_pixels=jnp.asarray(mpx), use_wandb=False,
        output_dir=str(tmp_path / "jax_inp"), feature_fn=jf, **kw)
    ours = teval.evaluate_model(
        _field(torch), tcodecs.SimpleResizeAE(latent_shape=(8, 8, 3), image_size=32),
        target_latents=torch.from_numpy(target), generator=torch.Generator(),
        cond={"class_cond": torch.from_numpy(cc).long(), "mask_cond": torch.from_numpy(mask)},
        source=torch.from_numpy(source), mask_pixels=torch.from_numpy(mpx),
        output_dir=str(tmp_path / "torch_inp"), feature_fn=tf, **kw)
    _assert_metrics(ours, ref)
    files = sorted(os.listdir(tmp_path / "torch_inp"))
    assert files == sorted(os.listdir(tmp_path / "jax_inp"))
    assert {"ema_mask_latents_rk4_16_epoch3.png", "ema_mask_pixels_rk4_16_epoch3.png"} <= set(files)
