"""The port's HDiT (flocoder_torch.models.hdit) against the JAX package's on
shared weights: two levels (widths 16 and 32, d_head 8), 8×8×2 latents at
patch 2 (4×4 tokens outer, 2×2 inner), mapping width 32. The port's seeded
weights get seeded noise on every parameter, so that the zero-init
projections (``cond_scale``, ``out``, ``down``, ``patch_out``, MoE's
``down_kernel``) carry signal, and cross to the JAX module through the
weight bridge (``UNET_PREFIXES``). Inputs come from numpy seeds.

Tolerances (absolute): fp32 forward and gradients 1e-4·max(1, |ref|); the
bf16 forward 3e-2 of the largest |ref|; the MoE auxiliary loss 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flocoder_tpu.models import hdit as jh
from flocoder_tpu.training.checkpoint import flatten_tree, unflatten_tree
from flocoder_torch.config import load_config
from flocoder_torch.generate_samples import CONFIG_DIR
from flocoder_torch.models import hdit as th
from flocoder_torch.models.layers import init_params
from flocoder_torch.training.checkpoint import UNET_PREFIXES, to_jax_flat


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per xdist worker keeps these tests quick."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _levels(m, outer="na", moe=0):
    """The same levels as specs of either package (``m`` is the module)."""
    attn = (m.NeighborhoodAttentionSpec(d_head=8, kernel_size=3) if outer == "na"
            else m.GlobalAttentionSpec(d_head=8))
    return (m.LevelSpec(2, 16, 32, attn, moe_experts=moe, moe_capacity=0.75),
            m.LevelSpec(1, 32, 64, m.GlobalAttentionSpec(d_head=8)))


def _pair(n_classes=0, dual_time=False, outer="na", moe=0, dtype="float32", seed=0):
    """(port model, JAX model, JAX params) on the same perturbed weights."""
    kw = dict(channels=2, patch_size=2, n_classes=n_classes, dual_time=dual_time)
    tm = th.HDiT(_levels(th, outer, moe), th.MappingSpec(1, 32, 64),
                 dtype=getattr(torch, dtype), **kw)
    jm = jh.HDiT(_levels(jh, outer, moe), jh.MappingSpec(1, 32, 64),
                 dtype=getattr(jnp, dtype), **kw)
    init_params(tm, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in tm.parameters():
            p.add_(torch.from_numpy(0.1 * rng.normal(size=tuple(p.shape)).astype(np.float32)))
    params = unflatten_tree({k: jnp.asarray(v) for k, v in
                             to_jax_flat(tm, UNET_PREFIXES).items()})["model"]
    return tm, jm, params


def _inputs(B=3, seed=1, n_classes=0, dual_time=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, 8, 8, 2)).astype(np.float32)
    t = np.array([3.0, 500.0, 990.0][:B], np.float32)
    jc, tc = {"mask_cond": None}, {"mask_cond": None}
    if n_classes:
        cc = np.array([0, 2, -1][:B])                  # -1: the CFG null token
        jc["class_cond"], tc["class_cond"] = jnp.asarray(cc), torch.from_numpy(cc)
    if dual_time:
        h = (t + 200.0).astype(np.float32)
        jc["time_horizon"], tc["time_horizon"] = jnp.asarray(h), torch.from_numpy(h)
    return x, t, jc, tc


def _close(ours, ref, rel=1e-4, what=""):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(ours, np.float32), ref, rtol=0,
                               atol=rel * max(1.0, float(np.abs(ref).max())), err_msg=what)


@pytest.mark.parametrize("outer,n_classes,dual_time", [
    ("na", 3, False), ("global", 0, False), ("na", 0, True)])
def test_forward_matches_jax(outer, n_classes, dual_time):
    tm, jm, params = _pair(n_classes, dual_time, outer)
    x, t, jc, tc = _inputs(n_classes=n_classes, dual_time=dual_time)
    ref = jm.apply(params, jnp.asarray(x), jnp.asarray(t), jc)
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.from_numpy(t), tc)
    assert out.dtype == torch.float32 and out.shape == x.shape
    assert float(np.abs(np.asarray(ref)).max()) > 0.1          # the perturbation reaches it
    _close(out.numpy(), ref)


def test_bf16_forward_matches_jax():
    tm, jm, params = _pair(3, dtype="bfloat16", seed=2)
    x, t, jc, tc = _inputs(n_classes=3, seed=3)
    ref = np.asarray(jm.apply(params, jnp.asarray(x), jnp.asarray(t), jc), np.float32)
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.from_numpy(t), tc)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=3e-2 * np.abs(ref).max())


def test_neighborhood_attention_block_gradients_match_jax():
    """Input and parameter gradients of one NA block (4×4 tokens, k 3,
    heads 2 of d_head 8) under a seeded cotangent."""
    spec = dict(d_head=8, kernel_size=3)
    tb = th.SelfAttentionBlock(th.NeighborhoodAttentionSpec(**spec), 16, 32)
    init_params(tb, torch.Generator().manual_seed(4))
    rng = np.random.default_rng(4)
    with torch.no_grad():
        for p in tb.parameters():
            p.add_(torch.from_numpy(0.1 * rng.normal(size=tuple(p.shape)).astype(np.float32)))
    flat = to_jax_flat(tb, {"": "params"})
    jparams = unflatten_tree({k: jnp.asarray(v) for k, v in flat.items()})
    jb = jh.SelfAttentionBlock(jh.NeighborhoodAttentionSpec(**spec))
    x = rng.normal(size=(2, 4, 4, 16)).astype(np.float32)
    cond = rng.normal(size=(2, 32)).astype(np.float32)
    g = rng.normal(size=(2, 4, 4, 16)).astype(np.float32)

    def jloss(p, x, c):
        return jnp.sum(jb.apply(p, x, c) * g)

    jgp, jgx, jgc = jax.grad(jloss, argnums=(0, 1, 2))(jparams, jnp.asarray(x),
                                                      jnp.asarray(cond))
    xt, ct = (torch.from_numpy(a).requires_grad_() for a in (x, cond))
    (tb(xt, ct) * torch.from_numpy(g)).sum().backward()
    _close(xt.grad.numpy(), jgx, what="dx")
    _close(ct.grad.numpy(), jgc, what="dcond")
    grads = {name: p.grad for name, p in tb.named_parameters()}
    with torch.no_grad():
        for name, p in tb.named_parameters():
            p.copy_(grads[name])
    ref = flatten_tree(jgp)
    ours = to_jax_flat(tb, {"": "params"})
    assert set(ours) == set(ref)
    for k in ref:
        _close(ours[k], ref[k], what=k)


def test_moe_forward_and_aux_loss_match_jax():
    """MoE blocks at the outer level, capacity factor 0.75 so that some
    assignments are dropped: the velocity and the blocks' mean auxiliary
    loss (flax's sown ``moe_losses``)."""
    tm, jm, params = _pair(3, moe=4, seed=5)
    x, t, jc, tc = _inputs(n_classes=3, seed=6)
    ref, mut = jm.apply(params, jnp.asarray(x), jnp.asarray(t), jc, mutable=["moe_losses"])
    leaves = jax.tree_util.tree_leaves(mut)
    with torch.no_grad():
        out, aux = tm(torch.from_numpy(x), torch.from_numpy(t), tc, return_aux=True)
    _close(out.numpy(), ref)
    assert aux["moe_aux"].shape == (4,) == (len(leaves),)
    np.testing.assert_allclose(float(aux["moe_aux"].mean()), float(sum(leaves) / len(leaves)),
                               rtol=0, atol=1e-5)
    assert 0.0 < float(aux["moe_dropped"].max()) < 1.0


def test_config_builds_the_jax_parameter_tree():
    """``hdit_from_config`` gives the JAX function's parameter paths and
    shapes, at the recipe's variants (NA at patch 2; MoE at the outer
    level)."""
    over = ["flow.hdit_depths=[2,1]", "flow.hdit_widths=[32,64]",
            "flow.hdit_d_ffs=[48,96]", "flow.hdit_d_head=16",
            "flow.hdit_mapping_width=32", "flow.hdit_mapping_d_ff=48",
            "flow.hdit_patch_size=2", "flow.hdit_attns=[na:7,global]",
            "flow.hdit_moe_experts=[4,0]"]
    cfg = load_config("flowers_hdit", config_dir=CONFIG_DIR, overrides=over)
    tm = th.hdit_from_config(cfg, channels=4, n_classes=5)
    jm = jh.hdit_from_config(cfg, channels=4, n_classes=5, dtype=jnp.float32)
    v0 = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, 4)),
                        jnp.zeros((1,)), {"class_cond": jnp.zeros((1,), jnp.int32),
                                          "mask_cond": None})
    ref = {"model/params/" + "/".join(k.key for k in path): leaf.shape
           for path, leaf in jax.tree_util.tree_leaves_with_path(v0["params"])}
    ours = {k: v.shape for k, v in to_jax_flat(tm, UNET_PREFIXES).items()}
    assert ours == ref
    assert isinstance(tm.down_0_attn_1.spec, th.NeighborhoodAttentionSpec)
    assert tm.down_0_attn_1.spec.kernel_size == 7


def test_refusals():
    with pytest.raises(NotImplementedError, match="pp_stages.*ROADMAP"):
        th.HDiT(_levels(th), pp_stages=2)
    cfg = load_config("flowers_hdit", config_dir=CONFIG_DIR,
                      overrides=["+flow.hdit_pp_stages=2"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        th.hdit_from_config(cfg, channels=4, n_classes=0)
    tm, _, _ = _pair()
    x, t, _, tc = _inputs()
    with pytest.raises(ValueError, match="mask"):
        tm(torch.from_numpy(x), torch.from_numpy(t), {"mask_cond": torch.zeros(3, 8, 8, 2)})
    with pytest.raises(ValueError, match="divisible by 4"):
        tm(torch.zeros(1, 6, 6, 2), torch.zeros(1), None)
