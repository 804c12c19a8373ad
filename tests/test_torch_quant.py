"""The port's W8A8 int8 convolution (``flocoder_torch/ops/quant.py``) against
the JAX package's ``flocoder_tpu/ops/quant.py`` on the CPU, with the same
numpy inputs (NHWC and HWIO on the JAX side, NCHW and OIHW on the port's).

- The int8 codes of the activations and the weights equal those of the JAX
  function run op by op (``jax.disable_jit()``: every bf16 operation
  rounds, as torch's do), captured where it hands them to
  ``lax.conv_general_dilated``; the output is then within 1e-6 of the
  largest |output| (the same integers, dequantized by the same fp32
  operations).
- Under ``jit`` XLA computes ``x_bf / s_x`` and ``round`` without rounding
  the quotient to bf16 between them, so a code whose quotient sits within a
  bf16 ulp of a half-integer can move by one step. The output is held to
  the jitted function within 1e-2 of the largest |output|: a few codes of
  ±1 step each, out of K = 9·32 products a value.
- ``QuantConv`` below 32 channels runs the plain convolution in the compute
  dtype, as the JAX module does (bf16: 1e-2 of the largest |output|, one
  bf16 rounding apart), and has ``Conv``'s parameters.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flocoder_tpu.ops import quant as jquant
from flocoder_torch.models.layers import conv
from flocoder_torch.ops import quant as tquant
from flocoder_torch.training.checkpoint import _from_jax, to_jax_flat


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, cin=32, cout=40, k=3, size=8, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((2, size, size, cin)) * 1.7).astype(dtype)
    w = (rng.standard_normal((k, k, cin, cout)) / np.sqrt(k * k * cin)).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    return x, w, b


def _port(x, w, b, stride, padding, out_dtype=torch.float32):
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    wt = torch.from_numpy(np.ascontiguousarray(_from_jax(w, "conv")))
    return tquant.int8_conv(xt, wt, torch.from_numpy(b), stride, padding, out_dtype)


def _jax_op_by_op(x, w, b, stride, padding, monkeypatch):
    """The JAX function without jit, and the codes it convolves."""
    seen = {}
    orig = jax.lax.conv_general_dilated

    def capture(lhs, rhs, *a, **kw):
        seen["x_q"], seen["w_q"] = np.asarray(lhs), np.asarray(rhs)
        return orig(lhs, rhs, *a, **kw)

    monkeypatch.setattr(jax.lax, "conv_general_dilated", capture)
    pad = jquant._normalize_padding(padding, w.shape[:2])
    with jax.disable_jit():
        y = jquant.int8_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             (stride, stride), pad, jnp.float32)
    monkeypatch.setattr(jax.lax, "conv_general_dilated", orig)
    return np.asarray(y), seen


@pytest.mark.parametrize("k,stride,padding", [
    (1, 1, 0), (1, 2, "SAME"), (3, 1, 1), (3, 2, 1), (3, 1, "SAME"), (3, 2, "SAME"),
])
def test_int8_conv_matches_jax(k, stride, padding, monkeypatch):
    x, w, b = _inputs(10 * k + stride, k=k)
    y_ref, seen = _jax_op_by_op(x, w, b, stride, padding, monkeypatch)
    x_q, _ = tquant.quantize_activations(torch.from_numpy(x))
    w_q, _ = tquant.quantize_weight(torch.from_numpy(np.ascontiguousarray(_from_jax(w, "conv"))))
    np.testing.assert_array_equal(x_q.to(torch.int8).numpy(), seen["x_q"])
    np.testing.assert_array_equal(w_q.numpy(), _from_jax(seen["w_q"], "conv"))
    assert np.abs(seen["x_q"]).max() >= 120 and len(np.unique(seen["x_q"])) > 150
    y = _port(x, w, b, stride, padding).permute(0, 2, 3, 1).numpy()
    assert y.shape == y_ref.shape
    scale = np.abs(y_ref).max()
    np.testing.assert_allclose(y, y_ref, rtol=0, atol=1e-6 * scale)
    pad = jquant._normalize_padding(padding, w.shape[:2])
    y_jit = np.asarray(jax.jit(lambda *a: jquant.int8_conv(*a, (stride, stride), pad,
                                                           jnp.float32))(x, w, b))
    np.testing.assert_allclose(y, y_jit, rtol=0, atol=1e-2 * scale)


def test_int8_conv_takes_bf16_and_gives_the_output_dtype(monkeypatch):
    """A bf16 input (a bf16 codec's activations) and a bf16 output."""
    x, w, b = _inputs(5)
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    with jax.disable_jit():
        y_ref = jquant.int8_conv(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), jnp.asarray(b),
                                 (1, 1), ((1, 1), (1, 1)), jnp.bfloat16)
    y = tquant.int8_conv(torch.from_numpy(xb.transpose(0, 3, 1, 2).copy()).bfloat16(),
                         torch.from_numpy(np.ascontiguousarray(_from_jax(w, "conv"))),
                         torch.from_numpy(b), 1, 1, torch.bfloat16)
    assert y.dtype == torch.bfloat16
    np.testing.assert_array_equal(y.float().permute(0, 2, 3, 1).numpy(),
                                  np.asarray(y_ref.astype(jnp.float32)))


@pytest.mark.parametrize("cin,cout", [(8, 16), (64, 4)])
def test_quant_conv_below_32_channels_is_the_plain_conv(cin, cout):
    x, w, b = _inputs(cin, cin=cin, cout=cout)
    mod = jquant.QuantConv(cout, (3, 3), padding=1, dtype=jnp.bfloat16)
    y_ref = mod.apply({"params": {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}},
                      jnp.asarray(x))
    tc = tquant.conv_or_quant(True, cin, cout, 3, dtype=torch.bfloat16)
    assert isinstance(tc, tquant.QuantConv)
    with torch.no_grad():
        tc.weight.copy_(torch.from_numpy(np.ascontiguousarray(_from_jax(w, "conv"))))
        tc.bias.copy_(torch.from_numpy(b))
        y = tc(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    assert y.dtype == torch.bfloat16 and tquant.int_mm_calls.launches == 0
    ref = np.asarray(y_ref.astype(jnp.float32))
    np.testing.assert_allclose(y.float().permute(0, 2, 3, 1).numpy(), ref, rtol=0,
                               atol=1e-2 * np.abs(ref).max())


def test_quant_conv_has_the_parameters_of_conv():
    """The same state_dict keys and shapes as ``layers.Conv``, and through
    the bridge the JAX QuantConv's parameter tree."""
    q, c = tquant.conv_or_quant(True, 32, 48, 3), conv(32, 48, 3)
    assert {k: v.shape for k, v in q.state_dict().items()} == \
        {k: v.shape for k, v in c.state_dict().items()}
    params = jquant.QuantConv(48, (3, 3), padding=1).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 32)))["params"]
    flat = to_jax_flat(q, {"": "params"})
    assert {k: v.shape for k, v in flat.items()} == \
        {f"params/{k}": v.shape for k, v in params.items()}
    x = torch.randn(2, 32, 8, 8)
    with torch.no_grad():
        q.weight.copy_(c.weight)
        q.bias.copy_(c.bias)
        rel = (q(x) - c(x)).abs().max() / c(x).abs().max()
    assert 0 < rel < 2e-2         # int8 error, an order under the output's scale
