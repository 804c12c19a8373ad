"""The port's SD VAE in bf16, alone and with the W8A8 int8 encoder or
decoder, against the JAX SD VAE at the same flags, on the CPU at channels
32, 32, 64, 64 on 32² images (4×4×4 latents). Weights, the op-by-op JAX
run and the 3e-2 bound as in ``test_torch_codec_bf16.py``.

The int8 encode takes 5e-2 of the largest |ref|. Its first int8
convolutions come after a GroupNorm whose fp32 statistics differ from
flax's by an ulp (flax takes E[x²] − E[x]²), and a bf16 value one ulp apart
moves its code a step where the quotient sits near a half. Eight resnets of
such steps put the port 3.2e-2 from the op-by-op JAX encode; the JAX encode
under ``jit`` is 6.5e-2 from its own op-by-op run. bf16 alone, and the
int8 decode, stay within 3e-2 (1e-2 and 6e-3 here).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flocoder_tpu.models.sd_vae import SDVAE as JaxSDVAE
from flocoder_tpu.training.checkpoint import unflatten_tree
from flocoder_torch.models.sd_vae import SDVAE
from flocoder_torch.training.checkpoint import SDVAE_PREFIXES, load_jax_flat

from test_torch_codec_bf16 import _close, _perturbed_flat


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SD_CH = (32, 32, 64, 64)


def test_sd_vae_in_bf16_matches_jax():
    x = np.random.default_rng(1).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    zin = np.random.default_rng(2).normal(size=(2, 4, 4, 4)).astype(np.float32)
    flat = _perturbed_flat(SDVAE(image_size=32, channels=SD_CH, weights_path=""),
                           SDVAE_PREFIXES, 0)
    params = unflatten_tree({k: jnp.asarray(v) for k, v in flat.items()})
    for quant in ("", "encode", "decode"):
        kw = dict(quant_encode=quant == "encode", quant_decode=quant == "decode")
        tc = SDVAE(image_size=32, channels=SD_CH, weights_path="", dtype=torch.bfloat16, **kw)
        load_jax_flat(tc, flat, SDVAE_PREFIXES)
        jm = JaxSDVAE(image_size=32, channels=SD_CH, weights_path="", dtype=jnp.bfloat16, **kw)
        with torch.inference_mode():
            z = tc.encode(torch.from_numpy(x))
            y = tc.decode(torch.from_numpy(zin))
        assert z.dtype == y.dtype == torch.bfloat16
        _close(z, jm.encode(params, jnp.asarray(x)), 5e-2 if quant == "encode" else 3e-2)
        _close(y, jm.decode(params, jnp.asarray(zin)), 3e-2)
