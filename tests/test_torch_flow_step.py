"""The port's flow-matching step (flocoder_torch.training.flow, ema,
schedules) against the JAX package's on the same U-Net weights (dim 8,
dim_mults (1, 2), 3 classes, 8×8×4 latents, B=8).

The random draws are injected: the port gets the noise, t, CFG noise and
drop gate that ``jax.random`` drew under the JAX step's own key split.

Tolerances (fp32): the loss 1e-4 absolute; gradients and Adam's first
moments (0.1 · the clipped gradient after one step) 1e-4 · the largest
|ref| of the model plus 1e-3 relative; parameters and EMA after a step
1e-4 absolute. The EMA update matches the JAX function bitwise; the
learning-rate schedule to 2·2⁻²³ of its base rate (XLA's fused and unfused
evaluations of it differ by as much); the batch-size schedule exactly.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flocoder_tpu.models.unet import Unet as JaxUnet
from flocoder_tpu.training import ema as jema
from flocoder_tpu.training import flow as jflow
from flocoder_tpu.training import schedules as jsched
from flocoder_tpu.training.checkpoint import flatten_tree, unflatten_tree
from flocoder_torch.models.layers import init_params
from flocoder_torch.models.unet import Unet
from flocoder_torch.training import ema as tema
from flocoder_torch.training import flow as tflow
from flocoder_torch.training import schedules as tsched
from flocoder_torch.training.checkpoint import UNET_PREFIXES, to_jax_flat


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per xdist worker keeps these tests quick."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL = 1e-4
B, S, C, NC = 8, 8, 4, 3


def _models(dual_time=False, seed=0):
    unet = init_params(Unet(dim=8, channels=C, dim_mults=(1, 2), n_classes=NC,
                            dual_time=dual_time), torch.Generator().manual_seed(seed))
    flat = to_jax_flat(unet, UNET_PREFIXES)
    jparams = unflatten_tree({k: jnp.asarray(v) for k, v in flat.items()})
    jm = JaxUnet(dim=8, channels=C, dim_mults=(1, 2), n_classes=NC, dual_time=dual_time)
    return unet, jparams, (lambda p, x, t, c: jm.apply(p, x, t, c))


def _batch(seed=1, n=B):
    rng = np.random.default_rng(seed)
    target = (rng.normal(size=(n, S, S, C)) * 0.7 + 0.2).astype(np.float32)
    cc = rng.integers(0, NC, n).astype(np.int32)
    return ({"target": jnp.asarray(target), "class_cond": jnp.asarray(cc)},
            {"target": torch.from_numpy(target), "class_cond": torch.from_numpy(cc).long()})


def _jax_draws(rng, n=B, meanflow=False):
    """The arrays JAX's grads_fn draws from ``rng`` (flow.py's key split)."""
    k_noise, k_cfgnoise, k_t, _ = jax.random.split(rng, 4)
    shape = (n, S, S, C)
    d = {"noise": jax.random.normal(k_noise, shape),
         "t_uniform": jax.random.uniform(k_t, (n,)),
         "cfg_noise": jax.random.normal(k_cfgnoise, shape)}
    if meanflow:
        d["r_uniform"] = jax.random.uniform(jax.random.fold_in(k_t, 1), (n,))
        d["sel_uniform"] = jax.random.uniform(jax.random.fold_in(k_t, 2), (n,))
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


def _grads(model) -> dict:
    m = copy.deepcopy(model)
    with torch.no_grad():
        for pm, p in zip(m.parameters(), model.parameters()):
            pm.copy_(p.grad)
    return to_jax_flat(m, UNET_PREFIXES)


def _assert_close_tree(ours: dict, ref: dict, what: str, scaled: bool):
    ref = {k: np.asarray(v, np.float64) for k, v in ref.items()}
    assert set(ours) == set(ref), what
    scale = max(np.abs(v).max() for v in ref.values()) if scaled else 1.0
    for k in ref:
        np.testing.assert_allclose(np.asarray(ours[k], np.float64), ref[k],
                                   rtol=1e-3 if scaled else 0, atol=ATOL * scale,
                                   err_msg=f"{what}: {k}")


@pytest.mark.parametrize("ot_method,drop", [("parallel", False), ("parallel", True),
                                            ("greedy", False), (None, False)])
def test_grads_fn_matches_jax(ot_method, drop):
    unet, jparams, japply = _models()
    jb, tb = _batch()
    rng = jax.random.PRNGKey(3)
    kw = dict(use_ot=ot_method is not None, ot_method=ot_method or "parallel")
    (jloss, jaux), jg = jflow.make_flow_grads_fn(japply, **kw)(
        jparams, jnp.zeros((), jnp.int32), jb, rng, jnp.asarray(drop))
    aux = tflow.make_flow_grads_fn(**kw)(unet, tb, torch.tensor(drop),
                                         draws=_jax_draws(rng))
    np.testing.assert_allclose(float(aux["loss"]), float(jloss), atol=ATOL)
    np.testing.assert_allclose(float(aux["loss_flow"]), float(jaux["loss_flow"]), atol=ATOL)
    _assert_close_tree(_grads(unet), flatten_tree(jg), "gradient", scaled=True)


def test_eval_step_matches_jax():
    unet, jparams, japply = _models(seed=20)
    jb, tb = _batch(21)
    rng = jax.random.PRNGKey(22)
    ref = jflow.make_flow_eval_step(japply)(jparams, jb, rng)
    k_noise, k_t = jax.random.split(rng)
    draws = {"noise": torch.from_numpy(np.asarray(jax.random.normal(k_noise, (B, S, S, C)))),
             "t_uniform": torch.from_numpy(np.asarray(jax.random.uniform(k_t, (B,))))}
    ours = tflow.make_flow_eval_step()(unet, tb, draws=draws)
    np.testing.assert_allclose(float(ours), float(ref), atol=ATOL)


def test_paired_source_keeps_the_coupling():
    """Reflow: the stored source is used as is, never re-paired, and the
    gate nulls the class without resampling the source."""
    unet, jparams, japply = _models(seed=23)
    jb, tb = _batch(24)
    src = np.random.default_rng(25).normal(size=(B, S, S, C)).astype(np.float32)
    jb["source"], tb["source"] = jnp.asarray(src), torch.from_numpy(src)
    rng = jax.random.PRNGKey(26)
    (jloss, _), _ = jflow.make_flow_grads_fn(japply, paired_source=True)(
        jparams, jnp.zeros((), jnp.int32), jb, rng, jnp.asarray(True))
    aux = tflow.make_flow_grads_fn(paired_source=True)(unet, tb, torch.tensor(True),
                                                       draws=_jax_draws(rng))
    np.testing.assert_allclose(float(aux["loss"]), float(jloss), atol=ATOL)


def test_ema_update_is_the_jax_update_bitwise():
    rng = np.random.default_rng(27)
    e = rng.normal(size=(7, 5)).astype(np.float32)
    p = rng.normal(size=(7, 5)).astype(np.float32)
    model = torch.nn.Linear(5, 7, bias=False)
    ema = tema.ema_init(model)
    assert not any(q.requires_grad for q in ema.parameters())
    with torch.no_grad():
        model.weight.copy_(torch.from_numpy(p))
        ema.weight.copy_(torch.from_numpy(e))
    ref = jnp.asarray(e)
    for _ in range(3):
        tema.ema_update(ema, model, 0.999)
        ref = jema.ema_update(ref, jnp.asarray(p), 0.999)
    np.testing.assert_array_equal(ema.weight.detach().numpy(), np.asarray(ref))


@pytest.mark.parametrize("kw", [dict(steps_per_epoch=4), dict(steps_per_epoch=7, T_mult=1),
                                dict(T_0=3, steps_per_epoch=5, T_mult=3, decay=0.5,
                                     eta_min=1e-6)])
def test_cosine_warm_restarts_decay_matches_jax(kw):
    counts = np.arange(0, 1200)
    ref = np.asarray(jax.jit(jax.vmap(jsched.cosine_warm_restarts_decay(1e-4, **kw)))(
        jnp.asarray(counts)), np.float64)
    sched = tsched.cosine_warm_restarts_decay(1e-4, **kw)
    ours = np.array([sched(int(c)) for c in counts])
    np.testing.assert_allclose(ours, ref, rtol=0, atol=2 * 2.0 ** -23 * 1e-4)
    # every warm restart (where the rate jumps back up) falls on the same step
    np.testing.assert_array_equal(np.diff(ours) > 1e-6, np.diff(ref) > 1e-6)


@pytest.mark.parametrize("kw", [dict(gamma=2.0, step_every=3, max_bs=100, multiple_of=8),
                                dict(gamma=1.5, milestones=(2, 5, 9), multiple_of=4),
                                dict()])
def test_batch_size_schedule_matches_jax_exactly(kw):
    ours, ref = tsched.batch_size_schedule(24, **kw), jsched.batch_size_schedule(24, **kw)
    assert [ours(e) for e in range(1, 30)] == [ref(e) for e in range(1, 30)]
    with pytest.raises(ValueError):
        tsched.batch_size_schedule(8, step_every=2, milestones=(3,))


def test_not_ported_options_raise():
    """The data-parallel and FSDP steps are ported
    (tests/test_torch_parallel_flow*.py); without a mesh ``fsdp`` builds
    the one-device step, with one it refuses forward-mode derivatives, and
    a model axis, ported since (tests/test_torch_ring_*.py), needs a world
    of ranks as the data axis does. MeanFlow refuses
    curvature and, as in the
    JAX package, the inpainting mask path (the mask encoder and OTF
    augmentation themselves are ported: tests/test_torch_flow_inpaint_step.py)."""
    from flocoder_torch.parallel import mesh as pmesh
    with pytest.raises(RuntimeError, match="torchrun"):
        pmesh.make_mesh(n_model=2)
    assert callable(tflow.make_flow_train_step(fsdp=True, curvature_weight=0.1))
    with pytest.raises(ValueError, match="forward-mode"):
        tflow.make_flow_train_step(mesh=object(), fsdp=True, curvature_weight=0.1)
    with pytest.raises(ValueError):
        tflow.make_flow_train_step(meanflow=True, curvature_weight=0.1)
    lin = torch.nn.Linear(1, 1)
    state = tflow.create_flow_state(lin, 1e-3, mask_encoder=torch.nn.Linear(1, 1))
    assert state.mask_opt is not None and state.ema_mask_encoder is not None
    with pytest.raises(ValueError, match="inpainting"):
        tflow.make_flow_train_step(meanflow=True)(state, {"target": torch.zeros(1)},
                                                  torch.Generator())
