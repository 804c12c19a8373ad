"""The port's ResNet50 logits and the weight converters
(``flocoder_torch/models/perceptual.py``) against the JAX package's
``flocoder_tpu/models/perceptual.py`` on the CPU.

- ``ResNet50Logits`` on the same random weights (the port's seeded init
  with every BatchNorm's statistics, scale and bias randomised, carried to
  JAX through the bridge, whose keys must be exactly the JAX variables')
  at a 64² input: logits within 1e-4·max(1, |ref|).
- ``make_resnet50_perceptual_fn`` without a weights file: a seeded random
  init, zero on equal images, positive and finite otherwise, gradients to
  the first image only (the JAX package's ``tests/test_parity_tail.py``).
- ``convert_torch_resnet50`` and ``convert_torch_vgg16`` on a random
  torchvision-shaped state_dict (``tests/oracles/torch_resnet50.py``, and
  VGG16's ``features[:16]``) give exactly the JAX converters' arrays; the
  weight files load through ``load_resnet50_weights`` /
  ``load_vgg16_weights`` and reproduce the torch oracle's outputs within
  1e-4·max(1, |ref|).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from flocoder_tpu.models import perceptual as jp
from flocoder_tpu.training.checkpoint import flatten_tree, unflatten_tree
from flocoder_torch.models import perceptual as tp
from flocoder_torch.models.layers import init_params
from flocoder_torch.training.checkpoint import RESNET_PREFIXES, to_jax_flat
from oracles.torch_resnet50 import ResNet50 as TorchResNet50


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(ours, ref, rel=1e-4):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape and np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=rel * max(1.0, float(np.abs(ref).max())))


def _random_bn(model, seed):
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, tp.BatchNorm):
                c = m.scale.shape[0]
                m.scale.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)))
                m.bias.copy_(torch.from_numpy(rng.normal(0, 0.1, c).astype(np.float32)))
                m.mean.copy_(torch.from_numpy(rng.normal(0, 0.05, c).astype(np.float32)))
                m.var.copy_(torch.from_numpy(rng.uniform(0.7, 1.3, c).astype(np.float32)))
            elif isinstance(m, nn.Linear):
                m.bias.copy_(torch.from_numpy(rng.normal(0, 0.1, m.bias.shape[0])
                                              .astype(np.float32)))
    return model


def test_resnet50_logits_match_jax():
    model = _random_bn(init_params(tp.ResNet50Logits(), torch.Generator().manual_seed(0)), 1)
    flat = to_jax_flat(model, RESNET_PREFIXES)
    x = np.random.default_rng(2).standard_normal((2, 64, 64, 3)).astype(np.float32) * 0.5
    jm = jp.ResNet50Logits()
    tmpl = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x[:1]))
    assert set(flatten_tree(tmpl)) == set(flat)
    ref = jax.jit(jm.apply)(unflatten_tree({k: jnp.asarray(v) for k, v in flat.items()}),
                            jnp.asarray(x))
    with torch.no_grad():
        logits = model.eval()(torch.from_numpy(x))
    assert logits.shape == (2, 1000)
    _close(logits.numpy(), ref)


def test_resnet50_perceptual_fn_random_init(tmp_path):
    fn = tp.make_resnet50_perceptual_fn(weights_path=str(tmp_path / "absent.npz"))
    a = torch.zeros(1, 64, 64, 3) + 0.5
    b = torch.ones(1, 64, 64, 3) * 0.25
    same, diff = float(fn(a, a)), float(fn(a, b))
    assert same == 0.0 and diff > 0.0 and np.isfinite(diff)
    x = torch.full((1, 64, 64, 3), 0.4, requires_grad=True)
    y = torch.full((1, 64, 64, 3), 0.6, requires_grad=True)
    fn(x, y).backward()
    assert float(x.grad.abs().max()) > 0.0 and (y.grad is None or float(y.grad.abs().max()) == 0)
    again = tp.make_resnet50_perceptual_fn(weights_path=str(tmp_path / "absent.npz"))
    assert float(again(a, b)) == diff                        # seeded


def test_convert_torch_resnet50_matches_jax_and_the_oracle(tmp_path):
    torch.manual_seed(0)
    oracle = TorchResNet50().eval()
    with torch.no_grad():       # random statistics, so that a mapping slip shows
        for m in oracle.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.05)
                m.running_var.uniform_(0.7, 1.3)
                m.weight.uniform_(0.5, 1.5)
                m.bias.normal_(0, 0.1)
    sd = oracle.state_dict()
    flat = tp.convert_torch_resnet50(sd)
    ref = flatten_tree(jp.convert_torch_resnet50(sd))
    assert set(flat) == set(ref)
    for k in flat:
        np.testing.assert_array_equal(flat[k], np.asarray(ref[k]), err_msg=k)
    path = str(tmp_path / "resnet50.npz")
    np.savez(path, **flat)
    model = tp.ResNet50Logits()
    assert tp.load_resnet50_weights(model, path) is model
    assert tp.load_resnet50_weights(model, str(tmp_path / "absent.npz")) is None
    x = np.random.default_rng(1).standard_normal((1, 64, 64, 3)).astype(np.float32) * 0.3
    with torch.no_grad():
        want = oracle(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).numpy()
        got = model.eval()(torch.from_numpy(x)).numpy()
    _close(got, want)


def test_convert_torch_vgg16_matches_jax_and_the_oracle(tmp_path):
    torch.manual_seed(3)
    layers, prev = [], 3
    for spec in (64, 64, "M", 128, 128, "M", 256, 256, 256):
        if spec == "M":
            layers.append(nn.MaxPool2d(2, 2))
        else:
            layers += [nn.Conv2d(prev, spec, 3, padding=1), nn.ReLU()]
            prev = spec
    oracle = nn.Sequential(*layers).eval()
    sd = {f"features.{i}.{k}": v for i, m in enumerate(oracle)
          for k, v in m.state_dict().items()}
    flat = tp.convert_torch_vgg16(sd)
    ref = jp.convert_torch_vgg16(sd)
    assert set(flat) == set(ref) and len(flat) == 14
    for k in flat:
        np.testing.assert_array_equal(flat[k], ref[k], err_msg=k)
    path = str(tmp_path / "vgg.npz")
    np.savez(path, **flat)
    model = tp.VGG16Features()
    assert tp.load_vgg16_weights(model, path) is model
    x = np.random.default_rng(2).standard_normal((1, 32, 32, 3)).astype(np.float32) * 0.5
    with torch.no_grad():
        want = oracle(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).numpy()
        got = model(torch.from_numpy(x))[-1].permute(0, 3, 1, 2).numpy()
    _close(got, want)
