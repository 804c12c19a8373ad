"""The port's quality scores (flocoder_torch.quality_runs) against the
JAX tool's (tools/quality_runs.py, loaded by path) on the CPU, on the same
weights (the port's seeded U-Net carried into the JAX U-Net by the port's
bridge), the same latents and the same starting noise (the JAX sampler's
draw, injected):
- ``_quality`` at RK4 over 4 grid points with CFG 2.0, and
  ``_data_sinkhorn_baseline``;
- ``img_quality`` at RK4 over 3 grid points, held against the steps of the
  JAX tool's ``img_quality`` closure (tools/quality_runs.py:697-718)
  composed from the JAX package's functions, with rp features at 256
  dimensions (a 2048-wide Newton–Schulz root is slow on one CPU thread).
Latents and decoded images agree within 1e-4; each score within 1e-4 of
its magnitude plus the unit of the last digit it is rounded to.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flocoder_torch import quality_runs as tq
from flocoder_torch.models.layers import init_params
from flocoder_torch.models.unet import Unet
from flocoder_torch.training.checkpoint import UNET_PREFIXES, to_jax_flat
from flocoder_tpu.models.unet import Unet as JaxUnet
from flocoder_tpu.training.checkpoint import unflatten_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "jax_quality_runs", os.path.join(REPO, "tools", "quality_runs.py"))
jq = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jq)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(ours, ref, quantum):
    """Within 1e-4 of |ref| plus the unit of the last rounded digit."""
    assert abs(ours - ref) <= 1e-4 * abs(ref) + quantum, (ours, ref)


def _close_scores(ours: dict, ref: dict):
    assert set(ours) == set(ref)
    for k, v in ref.items():
        if k == "nfe":
            assert ours[k] == v
        else:
            _close(ours[k], v, 1e-3 if k in ("class0_mean", "class1_mean", "center_abs_err",
                                             "separation", "color_acc")
                   else 1e-2 if k == "fid_px" else 1e-4)


def _unets(channels=2, n_classes=2, seed=0):
    """A seeded port U-Net (dim 8, dim_mults 1,2) in eval mode and the JAX
    U-Net with the same parameters."""
    unet = init_params(Unet(dim=8, dim_mults=(1, 2), channels=channels, n_classes=n_classes),
                       torch.Generator().manual_seed(seed)).eval()
    jparams = unflatten_tree({k: jnp.asarray(v) for k, v in
                              to_jax_flat(unet, UNET_PREFIXES).items()})["model"]
    jm = JaxUnet(dim=8, dim_mults=(1, 2), channels=channels, n_classes=n_classes)
    return jm, jparams, unet


def _jax_start(seed, shape):
    """The JAX sampler's starting noise for ``PRNGKey(seed)``."""
    return torch.from_numpy(np.array(jax.random.normal(
        jax.random.split(jax.random.PRNGKey(seed))[0], shape)))


def test_quality_and_baseline_match_jax():
    jm, jparams, unet = _unets()
    b = 8
    ref, ref_lat = jq._quality(lambda x, t, c: jm.apply(jparams, x, t, c),
                               np.random.default_rng(99), b=b, n_steps=4)
    ours, lat = tq._quality(lambda x, t, c: unet(x, t, c), np.random.default_rng(99), b=b,
                            n_steps=4, noise=_jax_start(5, (b, tq.H, tq.W, tq.C)))
    np.testing.assert_allclose(lat, ref_lat, rtol=0, atol=1e-4)
    _close_scores(ours, ref)
    assert ref["nfe"] == 12 and ref["separation"] != 0
    for seed in (99, 7):
        _close(tq._data_sinkhorn_baseline(np.random.default_rng(seed), b=16),
               jq._data_sinkhorn_baseline(np.random.default_rng(seed), b=16), 1e-4)


def test_img_quality_matches_the_jax_closure():
    from flocoder_torch.ops.fid import make_random_projection_features
    from flocoder_tpu.metrics import compute_sample_metrics
    from flocoder_tpu.models.codecs import SimpleResizeAE as JaxResizeAE
    from flocoder_tpu.ops.fid import make_random_projection_features as jax_rp
    from flocoder_tpu.sampling import generate_latents

    imgs, labels = tq._image_bank(n=30, seed=0)
    codec = tq.SimpleResizeAE(latent_shape=(16, 16, 4), image_size=64)
    with torch.no_grad():
        lats = codec.encode(torch.from_numpy(imgs)).numpy()
    task = tq.ImageTask(codec, lats, labels, imgs, torch.device("cpu"))
    jm, jparams, unet = _unets(channels=4, n_classes=3, seed=1)
    n, seed = 12, 11
    ours_fn = make_random_projection_features(dim=256, image_size=64)
    ours, dec = tq.img_quality(lambda x, t, c: unet(x, t, c), task, ours_fn, n_steps=3, n=n,
                               seed=seed, noise=_jax_start(seed, (n, 16, 16, 4)))

    # the JAX closure's steps (tools/quality_runs.py:697-718) on the same latents
    jcodec = JaxResizeAE(latent_shape=(16, 16, 4), image_size=64)
    cls = jnp.asarray(jq._balanced_cls(n))
    lat, nfe = jax.jit(lambda r: generate_latents(
        lambda x, t, c: jm.apply(jparams, x, t, c), (n, 16, 16, 4), r, method="rk4",
        n_steps=3, cond={"class_cond": cls, "mask_cond": None}, cfg_strength=2.0,
        t_scale=999.0))(jax.random.PRNGKey(seed))
    jdec = np.asarray(jcodec.decode({}, lat))
    r_lat, r_px = task.eval_batch(np.random.default_rng(seed + 1), n)
    m = compute_sample_metrics(lat, jnp.asarray(r_lat), jnp.asarray(jdec), jnp.asarray(r_px),
                               feature_fn=jax_rp(dim=256, image_size=64))
    energy = ((jdec + 1.0) / 2.0).mean(axis=(1, 2))
    ref = {"nfe": int(nfe), "fid_px": round(float(m["FID_px"]), 2),
           "sinkhorn_latent": round(float(m["sinkhorn"]), 4),
           "sinkhorn_px": round(float(m["sinkhorn_px"]), 4),
           "color_acc": round(float(np.mean(np.argmax(energy, axis=1) == np.asarray(cls))), 3)}
    np.testing.assert_allclose(dec, jdec, rtol=0, atol=1e-4)
    _close_scores(ours, ref)
