"""The flow step with the ring on a mesh with a model axis, at a tiny HDiT
NA variant (an NA level, k 3, on 8×8 tokens; a global level on 4×4, the
ring's site; widths 16 and 32, d_head 8, 3 classes; 8×8×4 latents).

- 1×2 (2 gloo ranks, one batch shard, the two model ranks replicas): the
  JAX package's ring step under ``shard_map`` on a 1×2 mesh of the virtual
  CPU mesh first equals its own step on a one-device mesh with the
  ring-free model (the same key: the shard index folded in is 0 on both),
  since the JAX mesh step reduces nothing on its data axis (ROADMAP.md §3)
  and has none to reduce here; then the port's ring step, on the draws
  that JAX step drew, matches it.
- 2×2 (4 ranks: two batch shards of 8 rows, each a ring of two): the
  port's step matches its documented function, the one-device step on the
  global batch of 16 as two microbatches (each batch shard's rows with
  its draws, OT within them), held by each step's change and Adam's first
  moments; and the mesh lays rank r out at data r // 2, model r % 2, as
  the JAX mesh lays out devices, with the batch rank's rows and seed.

On both meshes the model replicas end the step equal bit for bit. The
tolerances are ``test_torch_flow_step.py``'s and
``test_torch_parallel_flow.py``'s: the loss 1e-4, parameters and the EMA
1e-4 absolute (2·lr where the reference gradient is at fp32's noise
floor), Adam's first moments 1e-4 · the largest |μ| plus 1e-3 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flocoder_tpu.models import hdit as jh
from flocoder_tpu.parallel.mesh import make_mesh
from flocoder_tpu.parallel.mesh import shard_batch as jshard_batch
from flocoder_tpu.training import flow as jflow
from flocoder_tpu.training.checkpoint import flatten_tree, unflatten_tree
from flocoder_torch.models import hdit as th
from flocoder_torch.training import flow as tflow
from flocoder_torch.training.checkpoint import (UNET_PREFIXES, adam_to_jax_flat, load_jax_flat,
                                                to_jax_flat)
from test_torch_flow_step import _assert_close_tree
from test_torch_parallel_flow import _jax_mu, _mu, assert_params
from test_torch_parallel_ranks import ring_flow_rank, start_ranks

LR = 1e-4
NC, HW, C = 3, 8, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _levels(m):
    return (m.LevelSpec(1, 16, 32, m.NeighborhoodAttentionSpec(8, 3)),
            m.LevelSpec(1, 32, 64, m.GlobalAttentionSpec(8)))


KW = dict(channels=C, patch_size=1, n_classes=NC)


def _models(seed=0):
    """The port's HDiT kwargs and weights, and the JAX params and ring-free
    and ring modules, from one seeded tree: N(0, 1/fan_in) kernels, N(0,
    0.1²) elsewhere, so every zero-init projection carries signal."""
    jm = jh.HDiT(_levels(jh), jh.MappingSpec(1, 32, 64), **KW)
    jring = jh.HDiT(_levels(jh), jh.MappingSpec(1, 32, 64), ring_axis="model",
                    ring_axis_size=2, **KW)
    tmpl = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, C)),
                          jnp.zeros((1,)), {"class_cond": jnp.zeros((1,), jnp.int32),
                                            "mask_cond": None})["params"]
    rng = np.random.default_rng(seed)
    flat = {}
    for k, s in flatten_tree(jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, s.dtype), tmpl)).items():
        std = 1.0 / np.sqrt(np.prod(s.shape[:-1])) if k.endswith("kernel") and s.ndim > 1 \
            else 0.1
        flat[f"model/params/{k}"] = (std * rng.standard_normal(s.shape)).astype(s.dtype)
    tm = th.HDiT(_levels(th), th.MappingSpec(1, 32, 64), **KW)
    load_jax_flat(tm, flat, UNET_PREFIXES)
    jparams = unflatten_tree({k: jnp.asarray(v) for k, v in flat.items()})
    models = {"kw": dict(levels=_levels(th), mapping=th.MappingSpec(1, 32, 64), **KW),
              "sd": tm.state_dict()}
    return models, jparams, jm, jring


def _batch(seed, n):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(n, HW, HW, C)) * 0.7 + 0.2).astype(np.float32),
            rng.integers(0, NC, n).astype(np.int64))


def _folded_draws(rng, n):
    """The drop gate and the draws of the JAX mesh step on shard 0: its key
    split, the shard index 0 folded into each key."""
    k_gate, k_body = jax.random.split(rng)
    k_noise, k_cfgnoise, k_t, _ = (jax.random.fold_in(k, 0)
                                   for k in jax.random.split(k_body, 4))
    shape = (n, HW, HW, C)
    draws = {"noise": jax.random.normal(k_noise, shape),
             "t_uniform": jax.random.uniform(k_t, (n,)),
             "cfg_noise": jax.random.normal(k_cfgnoise, shape)}
    drop = bool(jax.random.uniform(k_gate) < 0.1)
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}, drop


def _jax_step(apply, jparams, target, cls, mesh, rng):
    tx = jflow.make_flow_optimizer(LR)
    step = jflow.make_flow_train_step(apply, tx, mesh=mesh, donate=False, ema_decay=0.9)
    state = jflow.create_flow_state(jparams, tx)
    batch = jshard_batch(mesh, {"target": target, "class_cond": cls.astype(np.int32)})
    state, aux = step(state, batch, rng)
    return dict(loss=float(aux["loss"]), grad_norm=float(aux["grad_norm"]),
                params=flatten_tree(state.params), ema=flatten_tree(state.ema),
                mu=_jax_mu(state.opt_state))


def _hold(r, ref, what):
    np.testing.assert_allclose(r["aux"]["loss"], ref["loss"], atol=1e-4, err_msg=what)
    np.testing.assert_allclose(r["aux"]["grad_norm"], ref["grad_norm"], rtol=1e-4,
                               err_msg=what)
    assert_params(r["params"], ref["params"], ref["mu"], LR, f"{what} parameters")
    assert_params(r["ema"], ref["ema"], ref["mu"], 0.1 * LR, f"{what} EMA")
    _assert_close_tree(_mu(r), ref["mu"], f"{what} Adam mu", scaled=True)


def _same_bits(a, b) -> bool:
    return all(np.array_equal(a[g][k], b[g][k]) for g in ("params", "ema", "opt")
               for k in a[g])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds started first; the JAX steps and the port's one-device
    reference beside them."""
    tmp = tmp_path_factory.mktemp("ring_flow")
    models, jparams, jm, jring = _models()
    rng = jax.random.PRNGKey(5)
    draws, drop = _folded_draws(rng, 8)
    target, cls = _batch(6, 8)
    one_by_two = start_ranks(ring_flow_rank, 2, tmp, 2, models, target, cls, [draws], drop, LR)
    target2, cls2 = _batch(7, 16)
    g = torch.Generator().manual_seed(8)
    draws2 = [tflow.draw_flow_inputs(g, (8, HW, HW, C)) for _ in range(2)]
    two_by_two = start_ranks(ring_flow_rank, 4, tmp, 2, models, target2, cls2, draws2, True,
                             LR)

    jax_ring = _jax_step(lambda p, x, t, c: jring.apply(p, x, t, c), jparams, target, cls,
                         make_mesh(n_data=1, n_model=2, devices=jax.devices()[:2]), rng)
    jax_one = _jax_step(lambda p, x, t, c: jm.apply(p, x, t, c), jparams, target, cls,
                        make_mesh(n_data=1, n_model=1, devices=jax.devices()[:1]), rng)

    model = th.HDiT(**models["kw"])
    model.load_state_dict(models["sd"])
    state = tflow.create_flow_state(model, LR)
    step = tflow.make_flow_train_step(grad_accum=2, ema_decay=0.9)
    state, aux = step(state, {"target": torch.from_numpy(target2),
                              "class_cond": torch.from_numpy(cls2)}, None, draws=draws2,
                      drop=torch.tensor(True))
    flat = adam_to_jax_flat(state.model, state.opt.adam, state.step, UNET_PREFIXES)
    one_device = dict(loss=float(aux["loss"]), grad_norm=float(aux["grad_norm"]),
                      params=to_jax_flat(state.model, UNET_PREFIXES),
                      ema=to_jax_flat(state.ema, UNET_PREFIXES),
                      mu={k[len("1/0/mu/"):]: v for k, v in flat.items()
                          if k.startswith("1/0/mu/")})
    return dict(jax_ring=jax_ring, jax_one=jax_one, one_device=one_device,
                one_by_two=one_by_two.join(), two_by_two=two_by_two.join())


def test_jax_ring_step_is_its_one_device_step(runs):
    ring, one = runs["jax_ring"], runs["jax_one"]
    np.testing.assert_allclose(ring["loss"], one["loss"], atol=1e-4)
    np.testing.assert_allclose(ring["grad_norm"], one["grad_norm"], rtol=1e-4)
    assert_params(ring["params"], one["params"], one["mu"], LR, "JAX ring parameters")
    _assert_close_tree(ring["mu"], one["mu"], "JAX ring Adam mu", scaled=True)


def test_one_by_two_ring_step_matches_jax(runs):
    ranks = runs["one_by_two"]
    for r in ranks:
        _hold(r, runs["jax_ring"], f"1x2 rank {r['layout']['model_rank']}")
    assert _same_bits(ranks[0], ranks[1])           # the model replicas


def test_two_by_two_ring_step_is_the_documented_function(runs):
    ranks = runs["two_by_two"]
    for rank, r in enumerate(ranks):
        lay = r["layout"]
        assert lay["dims"] == ("data", "model") and lay["shape"] == (2, 2)
        assert lay["coord"] == [rank // 2, rank % 2] and lay["n_batch"] == 2
        assert lay["batch_rank"] == rank // 2 and lay["model_rank"] == rank % 2
        _hold(r, runs["one_device"], f"2x2 rank {rank}")
    assert _same_bits(ranks[0], ranks[1]) and _same_bits(ranks[2], ranks[3])
    seeds = [r["layout"]["seed"] for r in ranks]
    assert seeds[0] == seeds[1] != seeds[2] == seeds[3]

