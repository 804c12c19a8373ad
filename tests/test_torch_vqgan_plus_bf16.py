"""The port's VQGAN+ codec in bf16 and with the W8A8 int8 encoder or decoder
(fp32 and bf16 compute) against the JAX package's, on the CPU at small
widths (hidden 32, two downsamples, 16² images), on the weights of
``test_torch_vqgan_plus.py``. JAX runs op by op as in
``tests/test_torch_codec_bf16.py`` (every bf16 operation rounds, the int8
codes are the port's); under ``jit`` XLA keeps bf16 quotients unrounded and
moves int8 codes a step.

Tolerance: 3e-2 of the largest |ref|, the rule of the VQGAN codec's bf16
and int8 tests. The parameter tree is the same with and without int8.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flocoder_torch.models import vqgan_plus as tvp
from flocoder_torch.ops import quant as tquant
from flocoder_torch.training.checkpoint import VQVAE_PREFIXES, load_jax_flat, to_jax_flat
from flocoder_tpu.models import vqgan_plus as jvp
from test_torch_vqgan_plus import _close, _flat, _jax_params, _kw


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dtype,quant", [("bf16", ""), ("bf16", "encode"),
                                         ("bf16", "decode"), ("fp32", "encode"),
                                         ("fp32", "decode")])
def test_vqgan_plus_bf16_and_int8_match_jax_op_by_op(dtype, quant):
    kw = _kw(2, hidden=32, internal=32)
    flat = _flat(kw, 11)
    qkw = dict(quant_encode=quant == "encode", quant_decode=quant == "decode")
    tdt, jdt = ((torch.bfloat16, jnp.bfloat16) if dtype == "bf16"
                else (torch.float32, jnp.float32))
    tc = tvp.VQGANPlus(**kw, dtype=tdt, **qkw)
    assert set(to_jax_flat(tc, VQVAE_PREFIXES)) == set(flat)      # the tree, with int8 too
    load_jax_flat(tc, flat, VQVAE_PREFIXES)
    tc.eval()
    jc = jvp.VQGANPlus(**kw, dtype=jdt, **qkw)
    x = np.random.default_rng(6).uniform(0, 1, (2, 16, 16, 3)).astype(np.float32)
    params = _jax_params(jc, flat, x)
    zin = np.random.default_rng(7).normal(size=(2, 4, 4, 4)).astype(np.float32)
    tquant.int_mm_calls.launches = 0
    with torch.inference_mode():
        z = tc.encode(torch.from_numpy(x))
        y = tc.decode(torch.from_numpy(zin))
        zq = tc.quantize(z)[0]
    with jax.disable_jit():
        z_ref = jc.encode(params, jnp.asarray(x))
        y_ref = jc.decode(params, jnp.asarray(zin))
    assert z.dtype == y.dtype == zq.dtype == tdt and z_ref.dtype == jdt
    _close(z, z_ref, 3e-2, floor=0.0)
    _close(y, y_ref, 3e-2, floor=0.0)
    assert tquant.int_mm_calls.launches == 0            # the CPU runs the twin
