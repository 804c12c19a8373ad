"""The port's U-Net in bf16 (``Unet(dtype=torch.bfloat16)``: fp32
parameters, flax's compute-dtype casts) against the JAX U-Net at
``dtype=jnp.bfloat16`` on the same weights: dim 8, dim_mults (1, 2, 4),
16×16×4 latents, 3 classes (with the CFG null token), with and without the
mask path (the mask resized into the first two scales, a mask not all
ones, the all-ones bypass); and one bf16 flow step's loss against the JAX
step's with the draws injected (dim 8, dim_mults (1, 2), 8×8×4, B=8). An
fp32 U-Net copied to float64 computes in float64 (the card-against-CPU
checks take its step in float64), within 1e-4 of its fp32 forward (the
U-Net's fp32 parity tolerance).

Tolerance: 3e-2 of the largest |ref| (the bf16 HDiT test's): both compute
in bf16, and single roundings that differ by one bf16 ulp grow through the
blocks. The weights get seeded noise on every parameter so that each layer
carries signal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flocoder_torch.models.layers import init_params
from flocoder_torch.models.unet import Unet
from flocoder_torch.training import flow as tflow
from flocoder_torch.training.checkpoint import UNET_PREFIXES, to_jax_flat
from flocoder_tpu.models.unet import Unet as JaxUnet
from flocoder_tpu.training import flow as jflow
from flocoder_tpu.training.checkpoint import unflatten_tree

REL = 3e-2
B, S, C, NC = 3, 16, 4, 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(mask_cond=False, dim_mults=(1, 2, 4), seed=5):
    kw = dict(dim=8, channels=C, dim_mults=dim_mults, n_classes=NC, mask_cond=mask_cond,
              mask_channels=C)
    unet = init_params(Unet(dtype=torch.bfloat16, **kw), torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in unet.parameters():
            p.add_(torch.from_numpy(0.05 * rng.normal(size=tuple(p.shape)).astype(np.float32)))
    params = unflatten_tree({k: jnp.asarray(v) for k, v in
                             to_jax_flat(unet, UNET_PREFIXES).items()})
    return unet, params["model"], JaxUnet(dtype=jnp.bfloat16, **kw)


def _close(ours, ref, what=""):
    ref = np.asarray(ref, np.float32)
    ours = np.asarray(ours, np.float32)
    assert ours.dtype == ref.dtype == np.float32
    np.testing.assert_allclose(ours, ref, rtol=0, atol=REL * float(np.abs(ref).max()),
                               err_msg=what)


@pytest.mark.parametrize("mask", [None, "partial", "ones"])
def test_bf16_unet_matches_jax(mask):
    unet, params, jm = _pair(mask_cond=mask is not None)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(B, S, S, C)).astype(np.float32)
    t = np.array([3.0, 500.0, 990.0], np.float32)
    cc = np.array([0, 2, -1])
    m = None
    if mask == "partial":
        m = rng.random((B, S, S, C)).astype(np.float32)
    elif mask == "ones":
        m = np.ones((B, S, S, C), np.float32)
    ref = jax.jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(t),
                            {"class_cond": jnp.asarray(cc),
                             "mask_cond": None if m is None else jnp.asarray(m)})
    with torch.no_grad():
        got = unet(torch.from_numpy(x), torch.from_numpy(t),
                   {"class_cond": torch.from_numpy(cc),
                    "mask_cond": None if m is None else torch.from_numpy(m)})
    assert got.dtype == torch.float32 and ref.dtype == jnp.float32
    _close(got.numpy(), ref, f"mask={mask}")
    # bf16 differs from fp32 by more than the tolerance's noise: the test
    # would see a forward that silently ran in fp32
    fp32 = Unet(dim=8, channels=C, dim_mults=(1, 2, 4), n_classes=NC,
                mask_cond=mask is not None, mask_channels=C)
    fp32.load_state_dict(unet.state_dict())
    with torch.no_grad():
        full = fp32(torch.from_numpy(x), torch.from_numpy(t),
                    {"class_cond": torch.from_numpy(cc),
                     "mask_cond": None if m is None else torch.from_numpy(m)})
    assert (full - got).abs().max() > 1e-3


def test_bf16_flow_step_loss_matches_jax():
    unet, params, jm = _pair(dim_mults=(1, 2), seed=11)
    n, s = 8, 8
    rng = np.random.default_rng(12)
    target = (rng.normal(size=(n, s, s, C)) * 0.7 + 0.2).astype(np.float32)
    cc = rng.integers(0, NC, n).astype(np.int32)
    key = jax.random.PRNGKey(13)
    (jloss, jaux), _ = jax.jit(jflow.make_flow_grads_fn(
        lambda p, x, t, c: jm.apply(p, x, t, c)))(
        {"model": params}, jnp.zeros((), jnp.int32),
        {"target": jnp.asarray(target), "class_cond": jnp.asarray(cc)}, key,
        jnp.asarray(False))
    k_noise, k_cfgnoise, k_t, _ = jax.random.split(key, 4)
    shape = (n, s, s, C)
    draws = {"noise": jax.random.normal(k_noise, shape),
             "t_uniform": jax.random.uniform(k_t, (n,)),
             "cfg_noise": jax.random.normal(k_cfgnoise, shape)}
    draws = {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}
    aux = tflow.make_flow_grads_fn()(
        unet, {"target": torch.from_numpy(target), "class_cond": torch.from_numpy(cc).long()},
        torch.tensor(False), draws=draws)
    ref = float(jloss)
    assert np.isfinite(ref) and np.isfinite(float(aux["loss"]))
    np.testing.assert_allclose(float(aux["loss"]), ref, rtol=0, atol=REL * abs(ref))
    np.testing.assert_allclose(float(aux["loss_flow"]), float(jaux["loss_flow"]), rtol=0,
                               atol=REL * abs(ref))
    grads = [p.grad for p in unet.parameters()]
    assert all(g is not None and g.dtype == torch.float32 and torch.isfinite(g).all()
               for g in grads)


def test_fp32_unet_computes_in_its_parameters_dtype():
    unet = init_params(Unet(dim=8, channels=C, dim_mults=(1, 2), n_classes=NC,
                            mask_cond=True, mask_channels=C), torch.Generator().manual_seed(3))
    wide = Unet(dim=8, channels=C, dim_mults=(1, 2), n_classes=NC, mask_cond=True,
                mask_channels=C).double()
    wide.load_state_dict({k: v.double() for k, v in unet.state_dict().items()})
    seen = []
    for m in wide.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.GroupNorm, torch.nn.Linear)):
            m.register_forward_hook(lambda m, i, o: seen.append(o.dtype))
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 8, 8, C))
    m = rng.random((2, 8, 8, C))
    cond = {"class_cond": torch.tensor([1, -1])}
    with torch.no_grad():
        got = wide(torch.from_numpy(x), torch.tensor([3.0, 700.0], dtype=torch.float64),
                   {**cond, "mask_cond": torch.from_numpy(m)})
        ref = unet(torch.from_numpy(x).float(), torch.tensor([3.0, 700.0]),
                   {**cond, "mask_cond": torch.from_numpy(m).float()})
    assert seen and set(seen) == {torch.float64}
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-4)
