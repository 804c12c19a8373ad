"""The port's quality-runs tool (flocoder_torch.quality_runs) against the
JAX tool (tools/quality_runs.py, loaded by path) on the CPU.

- The data: ``_make_batch``, ``_image_bank`` and the audio family's
  ``wav_batch`` (captured from the JAX ``run_audio`` by stubbing its codec
  and discriminator inits, which take the stream's first two batches) are
  byte-equal for a seed.
- ``_train``: 3 steps of the tool's U-Net (dim 8, dim_mults 1,2, 8×8×2) at
  B=8 with OT pairing, against the JAX ``_train`` on a one-device mesh
  (``MESH_SHARDS`` set to 1: OT over the whole batch of 8, as one shard of
  the JAX tool's 8-device mesh pairs). From the same initial parameters (the
  port's ``_unet`` init, carried into the JAX tool's ``_unet()`` by the
  port's bridge: a compile of the JAX init would add ~11 s to the ~25 s
  of the JAX step's) and with the JAX step's draws and CFG gate injected
  (the key split of ``make_flow_train_step``, the keys folded with the
  shard index 0), the per-step losses agree within 1e-4. The JAX step on
  the 8-device mesh is no reference here: with this JAX its ``pmean_typed``
  reduces nothing (``shard_map(check_rep=False)`` tracks no varying axes),
  so it returns device 0's loss and update (ROADMAP.md §3). One case only;
  the step without OT is held in tests/test_torch_flow_step.py, the
  blocked OT pairing in tests/test_torch_ot.py.
- ``run_pod`` raises, naming ROADMAP item 13.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flocoder_torch import quality_runs as tq
from flocoder_torch.training.checkpoint import UNET_PREFIXES, to_jax_flat
from flocoder_tpu.training.checkpoint import unflatten_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_quality_runs", os.path.join(REPO, "tools", "quality_runs.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jq = _load_jax_tool()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed,b,balanced", [(0, 64, False), (3, 8, True), (98, 64, True)])
def test_make_batch_is_byte_equal(seed, b, balanced):
    ours = tq._make_batch(np.random.default_rng(seed), b=b, balanced=balanced)
    ref = jq._make_batch(np.random.default_rng(seed), b=b, balanced=balanced)
    for k in ("target", "class_cond"):
        assert ours[k].dtype == ref[k].dtype and ours[k].tobytes() == ref[k].tobytes()


def test_image_bank_is_byte_equal():
    ours, ours_lab = tq._image_bank(n=10, seed=4)
    ref, ref_lab = jq._image_bank(n=10, seed=4)
    assert ours.dtype == ref.dtype and ours.tobytes() == ref.tobytes()
    assert ours_lab.tobytes() == ref_lab.tobytes()
    assert sorted(set(ours_lab.tolist())) == [0, 1, 2]


def test_wav_batch_is_byte_equal(monkeypatch):
    """The JAX ``run_audio``'s first two ``wav_batch(2)`` calls (its inits'
    inputs), captured by stubbing its codec and discriminator."""
    import flocoder_tpu.models.audio_codec as jac
    import flocoder_tpu.models.audio_disc as jad
    seen = []

    class Stop(Exception):
        pass

    class Stub:
        def __init__(self, *a, **kw):
            pass

        def init(self, key, x):
            seen.append(np.asarray(x))
            if len(seen) == 2:
                raise Stop
            return {"params": {}}

    monkeypatch.setattr(jac, "DACCodec", Stub)
    monkeypatch.setattr(jad, "DACDiscriminator", Stub)
    with pytest.raises(Stop):
        jq.run_audio(steps=1, gan_steps=1)
    rng = np.random.default_rng(5)
    for ref in seen:
        ours = tq._wav_batch(rng, 2)
        assert ref.shape == ours.shape == (2, 2048, 1)
        assert ours.dtype == ref.dtype and ours.tobytes() == ref.tobytes()
    hold = tq._wav_batch(np.random.default_rng(7777), 8)
    assert hold.shape == (8, 2048, 1) and np.isfinite(hold).all()


def _jax_draws(seed, steps, shape):
    """Step i's draws and gate as the JAX step on a one-device mesh takes
    them: the loop's key split, then the step's (gate, body) split and the
    body's four keys, each folded with the shard index 0."""
    key = jax.random.PRNGKey(seed + 1)
    out = []
    for _ in range(steps):
        key, k = jax.random.split(key)
        k_gate, k_body = jax.random.split(k)
        drop = bool(jax.random.uniform(k_gate) < 0.1)
        k_noise, k_cfg, k_t, _ = (jax.random.fold_in(x, 0)
                                  for x in jax.random.split(k_body, 4))
        d = {"noise": jax.random.normal(k_noise, shape),
             "t_uniform": jax.random.uniform(k_t, (shape[0],)),
             "cfg_noise": jax.random.normal(k_cfg, shape)}
        out.append(({k_: torch.from_numpy(np.array(v)) for k_, v in d.items()},
                    torch.tensor(drop)))
    return out


def test_train_losses_match_jax(monkeypatch):
    from flocoder_tpu.parallel.mesh import make_mesh
    monkeypatch.setattr(tq, "MESH_SHARDS", 1)
    jm = jq._unet()
    unet = tq._unet(device="cpu")
    jparams = unflatten_tree({k: jnp.asarray(v) for k, v in
                              to_jax_flat(unet, UNET_PREFIXES).items()})["model"]
    mesh = make_mesh(devices=jax.devices()[:1])
    _, ref = jq._train(lambda p, x, t, c: jm.apply(p, x, t, c), jparams, 3, b=8, mesh=mesh)
    draws = _jax_draws(0, 3, (8, tq.H, tq.W, tq.C))
    state, ours = tq._train(unet, 3, b=8, draws_fn=lambda i: draws[i])
    assert state.step == 3 and len(ours) == 3
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)
    assert ours[-1] != ours[0]           # the weights moved


def test_pod_raises_naming_item_13():
    with pytest.raises(NotImplementedError, match="item 13"):
        tq.run_pod(device="cpu")
    assert "pod" not in tq.DEFAULT_FAMILIES and set(tq.FAMILIES) == set(jq.FAMILIES)
