"""The ring sites of the port's models on 2 gloo ranks (a 1×2 mesh of the
model axis): the U-Net's bottleneck attention (dim 8, dim_mults (1, 2):
4×4 = 16 tokens), HDiT's NA variant (an NA level, k 3, on 8×8 tokens and
a global level on 4×4, widths 16 and 32, d_head 8) and the VQGAN decoder's
non-local attention (one head, q and k of width 2, v of width 4, on 4×4
latents), built with ``ring_axis_size=2``. Their weights come from the JAX
package's tree (``jax.eval_shape`` of ``init``, filled from a numpy seed:
N(0, 1/fan_in) kernels, N(0, 0.1²) elsewhere, so every zero-init
projection carries signal) through the weight bridge; the JAX ring modules
run under ``shard_map`` on 2 devices of the virtual CPU mesh. The forward
and the parameters' gradients of sum(out·w) match the JAX ring module's and
the port's ring-free module's: 1e-5 · max(1, |ref|) for the outputs, rtol
5e-4 / atol 5e-5 · the largest |gradient| for the gradients (the ring
attention test's tolerances). Every ring forward hops twice, and so does
every backward.

Then ``train_flow`` under a torchrun-style launch on 2 CPU ranks with
``flow.n_model=2 flow.ring_attention=true`` at a tiny HDiT NA variant: it
trains an epoch through the ring, its checkpoints equal one process's
ring-free run's on the same data and seed to 1e-5, and they load strictly
into the JAX ring-free model. And the refusals: MoE expert and pipeline
parallelism name ROADMAP item 13c, the codecs' tensor parallelism item
13b-ii; the ring refuses MeanFlow, the curvature penalty, FSDP and the
pipeline before a step, and forward-mode derivatives in the op itself.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flocoder_tpu.config import load_config as jload_config
from flocoder_tpu.models import codecs as jc
from flocoder_tpu.models import hdit as jh
from flocoder_tpu.models.unet import Unet as JaxUnet
from flocoder_tpu.parallel.mesh import P, make_mesh, pmean_typed, shard_map
from flocoder_tpu.training import checkpoint as jckpt
from flocoder_torch import train_flow as tf
from flocoder_torch.generate_samples import CONFIG_DIR
from flocoder_torch.parallel import mesh as pm
from flocoder_torch.parallel.ring_attention import ring_attention_replicated
from test_torch_parallel_ranks import ring_models_rank, script_rank, start_ranks

S = 2
MESH = make_mesh(n_data=1, n_model=S, devices=jax.devices()[:S])
B = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_flat(module, args, seed):
    """A seeded random tree of ``module.init``'s parameters, flat with the
    ``params/`` prefix, and the same as a JAX variables dict."""
    tmpl = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)["params"]
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), tmpl)
    rng = np.random.default_rng(seed)
    flat = {}
    for k, z in jckpt.flatten_tree(zeros).items():
        std = (1.0 / np.sqrt(np.prod(z.shape[:-1])) if k.endswith("kernel") and z.ndim > 1
               else 0.1)
        flat[k] = (std * rng.standard_normal(z.shape)).astype(z.dtype)
    return ({f"params/{k}": v for k, v in flat.items()},
            {"params": jckpt.unflatten_tree({k: jnp.asarray(v) for k, v in flat.items()})})


def _cases():
    """(rank case, JAX ring module's apply) for the three ring sites."""
    rng = np.random.default_rng(3)
    x8 = rng.standard_normal((B, 8, 8, 2)).astype(np.float32)
    x4 = rng.standard_normal((B, 8, 8, 4)).astype(np.float32)
    z = rng.standard_normal((B, 4, 4, 4)).astype(np.float32)
    t = np.array([100.0, 800.0], np.float32)
    ring = dict(ring_axis="model", ring_axis_size=S)
    unet_kw = dict(dim=8, channels=2, dim_mults=(1, 2))
    hdit_j = dict(levels=(jh.LevelSpec(1, 16, 32, jh.NeighborhoodAttentionSpec(8, 3)),
                          jh.LevelSpec(1, 32, 64, jh.GlobalAttentionSpec(8))),
                  mapping=jh.MappingSpec(1, 32, 64), channels=4, patch_size=1)
    dec_kw = dict(in_channels=3, hidden_channels=8, num_downsamples=1, internal_dim=8,
                  vq_embedding_dim=4, use_attention=False)
    cond = {"class_cond": None, "mask_cond": None}
    out = []
    for i, (build, jm, jring, kw, inputs) in enumerate([
            ("unet", JaxUnet(**unet_kw), JaxUnet(**unet_kw, **ring), unet_kw, (x8, t)),
            ("hdit", jh.HDiT(**hdit_j), jh.HDiT(**hdit_j, **ring),
             dict(levels=[(1, 16, 32, "na"), (1, 32, 64, "global")], mapping=(1, 32, 64),
                  channels=4, patch_size=1), (x4, t)),
            ("decoder", jc.VQVAEDecoder(**dec_kw), jc.VQVAEDecoder(**dec_kw, **ring), dec_kw,
             (z,))]):
        args = [jnp.asarray(a) for a in inputs] + ([cond] if build != "decoder" else [])
        flat, jparams = _random_flat(jm, args, seed=10 + i)
        apply = (lambda p, *a, m=jring: m.apply(p, *a, cond)) if build != "decoder" else \
            (lambda p, *a, m=jring: m.apply(p, *a))
        oshape = jax.eval_shape(jm.apply, jparams, *args).shape
        w = rng.standard_normal(oshape).astype(np.float32)
        out.append(({"build": build, "kw": kw, "flat": flat, "inputs": inputs, "w": w},
                    apply, jparams))
    return out


def _jax_ring(apply, params, inputs, w):
    """The JAX ring module's output and parameter gradients of sum(out·w),
    taken inside the shard_map as the train steps take them."""
    def body(p, *xs):
        def loss(p_):
            out = apply(p_, *xs)
            return jnp.sum(out * w), out
        (_, out), g = jax.value_and_grad(loss, has_aux=True)(p)
        names = ("model", "data")
        return pmean_typed(out, names), pmean_typed(g, names)

    f = shard_map(body, mesh=MESH, in_specs=(P(),) * (1 + len(inputs)),
                  out_specs=(P(), P()), check_rep=False)
    out, g = jax.jit(f)(params, *[jnp.asarray(a) for a in inputs])
    return np.asarray(out), {f"params/{k}": np.asarray(v)
                             for k, v in jckpt.flatten_tree(g["params"]).items()}


def _write_latents(root, n_train=32, n_val=8, seed=0):
    """Pre-encoded 8×8×4 latents in two class folders."""
    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        for i in range(n):
            d = os.path.join(root, split, f"c{i % 2}")
            os.makedirs(d, exist_ok=True)
            np.save(os.path.join(d, f"b{i}.npy"),
                    rng.normal(size=(8, 8, 4)).astype(np.float32))


HDIT_TINY = ["flow.arch=hdit", "flow.hdit_patch_size=1", "flow.hdit_attns=[na:3,global]",
             "flow.hdit_widths=[16,32]", "flow.hdit_d_ffs=[32,64]", "flow.hdit_d_head=8",
             "flow.hdit_mapping_width=32", "flow.hdit_depths=[1,1]"]
RING = ["+flow.n_model=2", "+flow.ring_attention=true"]


def _flow_argv(data, out, *extra):
    return ["--config-name", "smoke_vqgan", "+device=cpu", f"data={data}",
            "flow.batch_size=16", "flow.epochs=1", "flow.ckpt_every=1", "flow.no_eval=true",
            *HDIT_TINY, f"+ckpt_dir={out}/ck", f"+output_dir={out}/out", *extra]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both 2-rank worlds started first (the ring modules; train_flow with
    the ring), then the JAX ring modules and one process's ring-free
    train_flow beside them."""
    tmp = tmp_path_factory.mktemp("ring_models")
    data = str(tmp / "lat")
    _write_latents(f"{data}_encoded_vqgan")
    cases = _cases()
    models = start_ranks(ring_models_rank, S, tmp, [c for c, _, _ in cases])
    flow = start_ranks(script_rank, S, tmp, "train_flow",
                       _flow_argv(data, tmp / "ring", *RING), 0, env_init=True)
    refs = [_jax_ring(apply, jparams, c["inputs"], c["w"]) for c, apply, jparams in cases]
    one = tf.main(_flow_argv(data, tmp / "one"))
    return dict(cases=[c for c, _, _ in cases], refs=refs, models=models.join(),
                flow=flow.join(), one=one)


@pytest.mark.parametrize("i,site", [(0, "unet"), (1, "hdit"), (2, "decoder")])
def test_ring_site_matches_jax_and_the_ring_free_module(runs, i, site):
    assert runs["cases"][i]["build"] == site
    out_ref, g_ref = runs["refs"][i]
    g_scale = max(np.abs(v).max() for v in g_ref.values())
    for per_rank in runs["models"]:
        ring, plain = per_rank[i][S], per_rank[i][1]
        assert ring["hops"] == [S, S] and plain["hops"] == [0, 0]
        for ref_out, ref_g in ((out_ref, g_ref), (plain["out"], plain["grads"])):
            np.testing.assert_allclose(ring["out"], ref_out, rtol=0,
                                       atol=1e-5 * max(1.0, np.abs(ref_out).max()))
            assert set(ring["grads"]) == set(ref_g)
            for k, v in ref_g.items():
                np.testing.assert_allclose(ring["grads"][k], v, rtol=5e-4,
                                           atol=5e-5 * g_scale, err_msg=f"{site}: {k}")
    a, b = (r[i][S] for r in runs["models"])       # the replicas agree bit for bit
    np.testing.assert_array_equal(a["out"], b["out"])
    assert all(np.array_equal(a["grads"][k], b["grads"][k]) for k in a["grads"])


def test_train_flow_with_the_ring_on_two_ranks(runs):
    one = runs["one"]
    for r in runs["flow"]:
        assert r["ring"] and r["model_axis"] == S and r["ranks"] == 1 and not r["fsdp"]
        (ep,) = r["epochs"]
        assert r["epoch_seconds"][0]["steps"] == 2 and np.isfinite(ep["loss"])
        np.testing.assert_allclose(ep["loss"], one["epochs"][0]["loss"], rtol=1e-5)
    assert not one["ring"] and one["model_axis"] == 1
    ring_ck = runs["flow"][0]
    assert runs["flow"][1]["checkpoint"] is None       # rank 0 alone writes
    jcfg = jload_config("smoke_vqgan", config_dir=CONFIG_DIR, overrides=HDIT_TINY)
    jm = jh.hdit_from_config(jcfg, channels=4, n_classes=0, dtype=jnp.float32)
    tmpl = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)),
                          jnp.zeros((1,)), {"class_cond": None, "mask_cond": None})
    tmpl = {"model": {"params": jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                                       tmpl["params"])}}
    for key in ("checkpoint", "ema_checkpoint"):
        flat, flat_ref = (jckpt.flatten_tree(jckpt.load_checkpoint(r[key])["model_state_dict"])
                          for r in (ring_ck, one))
        params = jckpt.load_into_tree(tmpl, flat, strict=True)      # the ring-free tree
        assert set(flat) == set(flat_ref)
        for k, v in flat.items():
            np.testing.assert_allclose(v, flat_ref[k], rtol=0, atol=1e-5, err_msg=k)
        out = jm.apply(params["model"], jnp.ones((1, 8, 8, 4)), jnp.full((1,), 500.0),
                       {"class_cond": None, "mask_cond": None})
        assert np.isfinite(np.asarray(out)).all()


@pytest.mark.parametrize("extra,exc,match", [
    (["+flow.moe_ep=true"], NotImplementedError, "13c"),
    (["+flow.pp=true"], NotImplementedError, "13c"),
    ([*RING, "+flow.meanflow=true"], ValueError, "forward-mode.*custom_vjp"),
    ([*RING, "+flow.curvature_weight=0.1"], ValueError, "forward-mode.*custom_vjp"),
    ([*RING, "flow.fsdp=true"], ValueError, "FSDP step is plain jit"),
    ([*RING, "+flow.pp=true"], SystemExit, "both claim the mesh 'model' axis")],
    ids=["moe_ep", "pp", "ring_meanflow", "ring_curvature", "ring_fsdp", "ring_pp"])
def test_refusals_of_train_flow(tmp_path, extra, exc, match):
    with pytest.raises(exc, match=match):
        tf.main(_flow_argv(tmp_path / "absent", tmp_path, *extra))
    assert not (tmp_path / "out").exists()


def test_refusals_of_tensor_parallelism_and_forward_mode():
    from flocoder_torch import train_audio_codec as tac
    from flocoder_torch import train_vqgan as ttv
    for fn in (pm.tp_param_shardings, pm.shard_state_tp):
        with pytest.raises(NotImplementedError, match="13b-ii"):
            fn()
    with pytest.raises(NotImplementedError, match="13b-ii"):
        ttv.main(["--config-name", "smoke_vqgan", "+device=cpu", "+codec.tp=2"])
    with pytest.raises(NotImplementedError, match="13b-ii"):
        tac.main(["--config-name", "audio_dac", "+device=cpu", "+codec.tp=2"])
    q = torch.randn(1, 4, 1, 8)
    with pytest.raises(NotImplementedError, match="custom_vjp"):
        torch.func.jvp(lambda x: ring_attention_replicated(x, x, x, S), (q,), (q,))
    with pytest.raises(RuntimeError, match="torchrun"):
        pm.make_mesh(n_model=2)         # a model axis needs a world
