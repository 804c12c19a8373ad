"""Serving as trained, in bf16 and with the int8 decode, on the tiny
``tpu_vqgan`` of ``test_torch_bf16_slice.py`` (its codec checkpoint and a
``flow.bf16=true`` U-Net checkpoint), on the CPU: the port's
``generate_samples`` serves the checkpoint in bf16 with no flag (the U-Net
and the codec built in bf16) and takes ``+quant=int8`` (the decoder's W8A8
convolutions), against the JAX serving path at the same dtypes from the
same injected x0, Euler over 4 grid points (one velocity call a step keeps
JAX's compile short; RK4 is held in fp32 in ``test_torch_bf16_slice.py``).

- The sampled latents agree within 3e-2 of the largest |ref|: the bf16
  U-Nets are one or two bf16 roundings apart per layer (the JAX one runs
  under ``jit``).
- The decode of those (JAX's) latents agrees within 3e-2 of the largest
  |ref| in bf16 (JAX's decode run op by op, as in
  ``test_torch_codec_bf16.py``), and within 5e-2 with the int8 decoder:
  GroupNorm's fp32 statistics, summed in another order, move about one
  value in 10⁴ by a bf16 ulp; where that value is a tensor's largest it
  moves the per-tensor scale and with it every code of the next int8
  convolution by up to a step, and such steps compound through the
  decoder (4.3e-2 on this model; the JAX decoder under ``jit`` moves as far
  from its own op-by-op run).
- Decoding each package's own latents is not compared at int8 for the
  same reason (5.6e-2 here).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flocoder_tpu.sampling import generate_latents as jgenerate_latents
from flocoder_torch import evaluation as teval
from flocoder_torch import generate_samples as gs
from flocoder_torch.config import Config
from flocoder_torch.ops import quant as tquant

from test_torch_bf16_slice import SAMPLER, X0, codec_ckpt, flow_ckpt, jax_serving  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def served(codec_ckpt, tmp_path_factory):  # noqa: F811
    """The checkpoints, JAX's bf16 latents from X0 (one U-Net compile for
    both cases), and JAX's bf16 and bf16 + int8 decodes of them."""
    codec_path, codec_flat = codec_ckpt
    path, unet_flat = flow_ckpt(tmp_path_factory.mktemp("flow"), codec_path)
    apply, jc, jcp = jax_serving(codec_path, codec_flat, unet_flat, jnp.bfloat16)
    jlat = jax.jit(lambda x0: jgenerate_latents(
        apply, (2, 8, 8, 4), jax.random.PRNGKey(0), method="euler", n_steps=4,
        source=x0)[0])(X0)
    jlat = np.array(jlat.astype(jnp.float32))
    _, jq, jqp = jax_serving(codec_path, codec_flat, unet_flat, jnp.bfloat16, quant=True)
    decoded = {False: jc.decode(jcp, jnp.asarray(jlat)), True: jq.decode(jqp, jnp.asarray(jlat))}
    return path, jlat, {k: np.asarray(v.astype(jnp.float32)) for k, v in decoded.items()}


def _close(ours, ref, rel):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(ours.float().numpy(), ref, rtol=0,
                               atol=rel * float(np.abs(ref).max()))


@pytest.mark.parametrize("flags", [[], ["+quant=int8"]])
def test_generate_samples_serves_as_trained(flags, served, tmp_path):
    path, jlat, jdec = served
    quant = bool(flags)
    cli = Config({"quant": "int8"} if quant else {})
    b = gs.load_models_once(cli, path, torch.device("cpu"))
    assert (b["bf16"], b["quant"]) == (True, quant)
    assert b["model"].dtype == b["codec"].dtype == torch.bfloat16
    assert any(isinstance(m, tquant.QuantConv) for m in b["codec"].decoder.modules()) == quant
    assert gs.load_models_once(cli, path, torch.device("cpu")) is b
    lat, img, nfe = teval.sampler(b["model"], b["codec"], torch.Generator(),
                                  source=torch.from_numpy(X0), **dict(SAMPLER, method="euler"))
    assert nfe == 3 and img.shape == (2, 32, 32, 3) and img.dtype == torch.bfloat16
    assert float(np.abs(jlat - X0).max()) > 0.1                 # the field moved x0
    _close(lat, jlat, 3e-2)
    with torch.inference_mode():
        dec = b["codec"].decode(torch.from_numpy(jlat))
    _close(dec, jdec[quant], 5e-2 if quant else 3e-2)
    out = gs.main(["--config-name", "tpu_vqgan", "+device=cpu", f"+flow_checkpoint={path}",
                   "+n_samples=2", "+n_steps=3", f"+output_dir={tmp_path / 'out'}", *flags])
    assert out["images"].shape == (2, 32, 32, 3) and np.isfinite(out["images"]).all()
    assert (out["bf16"], out["quant"]) == (True, quant)
