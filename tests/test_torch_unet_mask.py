"""The port's U-Net with inpainting mask conditioning against the JAX
package's on the same weights (carried through the npz bridge): dim 8,
dim_mults (1, 2, 4, 8), 16×16×4 latents, so that the mask is resized into
the first two down scales (16, 8: a shrink, which jax antialiases) and the
first two up scales (2, 4). Three batches of masks: all ones (the input
fusion is bypassed), none all ones, and one mask not all ones (the bypass
is batch-global, so the fusion runs for every item); and no mask at all,
which both read as all ones. Tolerance 1e-4 absolute in fp32, as the
U-Net's other parity tests.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flocoder_torch.models.layers import init_params
from flocoder_torch.models.unet import Unet
from flocoder_torch.training.checkpoint import UNET_PREFIXES, to_jax_flat
from flocoder_tpu.models.unet import Unet as JaxUnet
from flocoder_tpu.training.checkpoint import unflatten_tree

ATOL = 1e-4
B, S, C = 3, 16, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    unet = init_params(Unet(dim=8, channels=C, mask_cond=True, mask_channels=C),
                       torch.Generator().manual_seed(5))
    params = unflatten_tree({k: jnp.asarray(v) for k, v in
                             to_jax_flat(unet, UNET_PREFIXES).items()})
    return unet, params, JaxUnet(dim=8, channels=C, mask_cond=True, mask_channels=C)


def _mask(kind, rng):
    m = rng.random((B, S, S, C)).astype(np.float32)
    if kind == "ones":
        return np.ones_like(m)
    if kind == "one_partial":
        m = np.ones_like(m)
        m[1, 3:9, 2:12] = 0.25
    return m


@pytest.mark.parametrize("kind", ["ones", "none_ones", "one_partial", "absent"])
def test_masked_unet_matches_jax(models, kind):
    unet, params, jm = models
    rng = np.random.default_rng(7)
    x = rng.normal(size=(B, S, S, C)).astype(np.float32)
    t = rng.uniform(0, 999, B).astype(np.float32)
    mask = None if kind == "absent" else _mask(kind, rng)
    ref = np.asarray(jm.apply(params["model"], jnp.asarray(x), jnp.asarray(t),
                              {"class_cond": None,
                               "mask_cond": None if mask is None else jnp.asarray(mask)}))
    with torch.no_grad():
        got = unet(torch.from_numpy(x), torch.from_numpy(t),
                   {"class_cond": None,
                    "mask_cond": None if mask is None else torch.from_numpy(mask)}).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_bypass_is_batch_global_and_needs_no_host_sync(models):
    """An all-ones batch skips the fusion (the output equals the mask-less
    forward's); one item that is not all ones changes every item's output.
    The bypass is a 0-dim ``torch.where``: the forward runs on a tensor
    subclass that forbids reading a value back to the host."""
    unet = models[0]
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(size=(B, S, S, C)).astype(np.float32))
    t = torch.full((B,), 500.0)
    with torch.no_grad():
        ones = unet(x, t, {"mask_cond": torch.ones(B, S, S, C)})
        none = unet(x, t, None)
        part = unet(x, t, {"mask_cond": torch.from_numpy(_mask("one_partial", rng))})
    assert torch.equal(ones, none)
    assert all((part[i] - ones[i]).abs().max() > 1e-6 for i in range(B))

    class NoSync(torch.Tensor):
        def __bool__(self):
            raise AssertionError("host sync")

        def item(self):
            raise AssertionError("host sync")

    with torch.no_grad():
        unet(x, t, {"mask_cond": torch.ones(B, S, S, C).as_subclass(NoSync)})
