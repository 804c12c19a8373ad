"""The port's FID-Inception features (flocoder_torch.models.inception) against
the JAX package's ``InceptionV3Features`` and ``make_inception_feature_fn``,
and ``fid_score`` on that backend.

The weights are a seeded random init with randomised BatchNorm parameters
and statistics (mean N(0, 0.05²), variance U(0.7, 1.3), scale N(1, 0.05²),
bias N(0, 0.05²)), as ``tests/test_fid_parity.py`` randomises its torch
oracle, so that a swapped mean/variance or scale/bias cannot hide; they
cross to JAX through the port's ``save_inception_weights`` and the JAX
``load_inception_weights`` (the JAX flat npz), and back. Held (fp32, XLA at
``highest`` precision):

- the network at 299² within 1e-3 of the largest |ref| (the oracle test's
  tolerance);
- ``make_inception_feature_fn`` on 32² uint8 images (upsampled to 299²) and
  on 320² float images (downsampled: ``jax.image.resize`` antialiases there,
  ``F.interpolate`` does not by default, and the test shows the two
  differ) within 1e-3 of the largest |ref|;
- ``fid_score`` with each package's Inception backend on the same images
  within 1e-3 relative, finite;
- the torchvision/pytorch-fid key names: the port's ``state_dict`` keys and
  shapes hash to the same SHA-256 as the FID-Inception tree's (564 entries,
  the hash taken from that tree once and copied here), and
  ``convert_torch_inception`` drops the classifier heads and loads strictly.
"""
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from flocoder_tpu.models import inception as jinc
from flocoder_tpu.ops import fid as jfid
from flocoder_torch.models import inception as tinc
from flocoder_torch.models.layers import init_params
from flocoder_torch.ops import fid as tfid

# sha256 of the sorted "key:shape" lines of torchvision's inception_v3
# state_dict with the FID-Inception blocks, without fc/AuxLogits
TORCH_TREE_SHA256 = "03b3e575d36d4f0de49f58c1c914f928b2201aeeacc904b77e46de741b88dfb0"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The port's randomised model, its npz and the JAX variables read
    from it."""
    model = init_params(tinc.InceptionV3Features(), torch.Generator().manual_seed(0)).eval()
    rng = np.random.default_rng(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.05, n)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.7, 1.3, n)))
                m.weight.copy_(torch.from_numpy(rng.normal(1.0, 0.05, n)))
                m.bias.copy_(torch.from_numpy(rng.normal(0, 0.05, n)))
    path = str(tmp_path_factory.mktemp("inception") / "fid_inception.npz")
    tinc.save_inception_weights(model, path)
    return dict(model=model, path=path, jvars=jinc.load_inception_weights(path))


def test_state_dict_has_torchvisions_names_and_converts():
    model = tinc.InceptionV3Features()
    sd = model.state_dict()
    lines = sorted(f"{k}:{tuple(v.shape)}" for k, v in sd.items())
    assert len(lines) == 564
    assert hashlib.sha256("\n".join(lines).encode()).hexdigest() == TORCH_TREE_SHA256
    full = dict(sd, **{"fc.weight": torch.zeros(1000, 2048), "fc.bias": torch.zeros(1000),
                       "AuxLogits.conv0.conv.weight": torch.zeros(128, 768, 1, 1)})
    full = {k: torch.randn(v.shape) if v.is_floating_point() else v for k, v in full.items()}
    conv = tinc.convert_torch_inception(full)
    assert not any(k.startswith(("fc.", "AuxLogits.")) or k.endswith("num_batches_tracked")
                   for k in conv)
    fresh = tinc.InceptionV3Features()
    missing, unexpected = fresh.load_state_dict(conv, strict=False)
    assert unexpected == [] and all(k.endswith("num_batches_tracked") for k in missing)
    assert torch.equal(fresh.Mixed_7c.branch_pool.conv.weight,
                       full["Mixed_7c.branch_pool.conv.weight"])
    with pytest.raises(ValueError, match="unrecognized"):
        tinc.convert_torch_inception({"Mixed_5b.branch1x1.weight": torch.zeros(1)})


def test_npz_round_trip_in_both_packages(weights, tmp_path):
    """The port's npz loads into the JAX tree (every leaf), and a file the
    JAX package writes loads into the port strictly."""
    jvars = weights["jvars"]
    shapes = jax.eval_shape(jinc.InceptionV3Features().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 299, 299, 3)))
    assert jax.tree_util.tree_structure(shapes) == jax.tree_util.tree_structure(jvars)
    assert all(a.shape == b.shape for a, b in zip(jax.tree_util.tree_leaves(shapes),
                                                  jax.tree_util.tree_leaves(jvars)))
    jinc.save_inception_weights(jvars, str(tmp_path / "j.npz"))
    state = tinc.load_inception_weights(str(tmp_path / "j.npz"))
    fresh = tinc.InceptionV3Features()
    fresh.load_state_dict(state, strict=False)
    ref = weights["model"].state_dict()
    assert all(torch.equal(v, ref[k]) for k, v in state.items())
    assert set(ref) - set(state) == {k for k in ref if k.endswith("num_batches_tracked")}
    assert tinc.load_inception_weights(str(tmp_path / "absent.npz")) is None


def test_network_matches_jax_at_299(weights):
    x = np.random.default_rng(3).standard_normal((1, 299, 299, 3)).astype(np.float32) * 0.5
    with torch.no_grad():
        ours = weights["model"](torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    ref = np.asarray(jax.jit(jinc.InceptionV3Features(fid_variant=True).apply)(
        weights["jvars"], jnp.asarray(x)))
    assert ours.shape == ref.shape == (1, 2048)
    assert np.abs(ours - ref).max() < 1e-3 * np.abs(ref).max()


def test_feature_fn_matches_jax_up_and_down(weights):
    """32² uint8 (upsampled) and 320² float (downsampled, antialiased as
    jax.image.resize is): the same pipeline, the same features."""
    ours_fn = tinc.make_inception_feature_fn(weights["path"])
    ref_fn = jinc.make_inception_feature_fn(variables=weights["jvars"])
    assert ours_fn.backend_name == "fid_inception"
    rng = np.random.default_rng(4)
    small = rng.integers(0, 256, (2, 32, 32, 3)).astype(np.uint8)
    big = np.clip(rng.normal(0, 0.6, (1, 320, 320, 1)), -1, 1).astype(np.float32)
    for imgs in (small, big):
        ours = ours_fn(torch.from_numpy(imgs)).numpy()
        ref = np.asarray(ref_fn(jnp.asarray(imgs)))
        assert ours.shape == ref.shape == (imgs.shape[0], 2048)
        assert np.abs(ours - ref).max() < 1e-3 * np.abs(ref).max(), imgs.shape
    # the downsampling case is the one a plain F.interpolate would get wrong
    x = torch.from_numpy(big).permute(0, 3, 1, 2).repeat(1, 3, 1, 1) * 127.5 + 127.5
    plain = F.interpolate(x, size=(299, 299), mode="bilinear", align_corners=False)
    w = torch.from_numpy(tfid.resize_weights(320, 299))
    ours_resize = torch.einsum("bchw,hi,wj->bcij", x, w, w)
    assert (plain - ours_resize).abs().max() > 1.0
    up = torch.from_numpy(small).permute(0, 3, 1, 2).float()
    w32 = torch.from_numpy(tfid.resize_weights(32, 299))
    torch.testing.assert_close(torch.einsum("bchw,hi,wj->bcij", up, w32, w32),
                               F.interpolate(up, size=(299, 299), mode="bilinear",
                                             align_corners=False), rtol=0, atol=1e-3)


def test_random_init_backend_and_fid_score_match_jax(weights):
    assert tinc.make_inception_feature_fn("/nonexistent.npz").backend_name == \
        "fid_inception_random_init"
    ours_fn = tinc.make_inception_feature_fn(state=tinc.load_inception_weights(weights["path"]))
    ref_fn = jinc.make_inception_feature_fn(variables=weights["jvars"])
    rng = np.random.default_rng(5)
    real = rng.integers(0, 256, (3, 32, 32, 3)).astype(np.uint8)
    fake = rng.integers(0, 256, (3, 32, 32, 3)).astype(np.uint8)
    ours = float(tfid.fid_score(torch.from_numpy(real), torch.from_numpy(fake),
                                feature_fn=ours_fn))
    ref = float(jfid.fid_score(jnp.asarray(real), jnp.asarray(fake), feature_fn=ref_fn))
    assert np.isfinite(ours) and ours > 0
    np.testing.assert_allclose(ours, ref, rtol=1e-3)
