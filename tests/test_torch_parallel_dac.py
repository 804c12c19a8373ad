"""Data-parallel DAC codec training: the port's reconstruction step on 2
gloo ranks (two clips each of a global batch of 4)
against the JAX package's ``_mesh_wrap`` step on a 2-device mesh
(gradients and losses ``pmean``ed; the fresh RVQ's k-means on each shard's
rows, shard 0's centres and reseeds broadcast, statistics ``psum``ed) on
the same random weights. Each rank is handed the draws every JAX shard
makes from the step's key for its rows (``jax_draws``). Models, sizes and
tolerances are ``test_torch_audio_step.py``'s (updated parameters 1e-4,
but for the sign flips of Adam's first step where the reference gradient
is below fp32's noise floor; first moments 1e-4 · the largest |μ| plus
1e-3 relative); the VQ indices exactly.

The named mutation: the ranks without the mesh (each keeps its own
k-means and statistics and steps on its own gradients) miss the JAX
codec.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flocoder_tpu.parallel.mesh import make_mesh as jax_make_mesh
from flocoder_tpu.training import audio as jaudio
from flocoder_tpu.training import vqgan as jvqgan
from flocoder_torch.models import audio_codec as tac
from flocoder_torch.training.checkpoint import DAC_PREFIXES
from test_torch_audio_codec import KW
from test_torch_audio_step import LR, OVERRIDES, T, assert_updated, jax_draws, setup, waves
from test_torch_parallel_ranks import codec_rank, start_ranks
from test_torch_vqgan_step import _assert_grads, _jax_codec_flat, _jax_moments


def test_two_rank_dac_step_matches_jax_mesh(tmp_path):
    s = setup()
    x = np.concatenate([waves(3), waves(5)])             # 4 clips, 2 a rank
    key = jax.random.PRNGKey(4)
    models = {"codec_cls": tac.DACCodec, "codec_kw": KW, "codec_sd": s["codec"].state_dict(),
              "config": "audio_dac", "prefixes": DAC_PREFIXES}
    draws = jax_draws(key, 2 * T // s["codec"].hop)
    ranks = start_ranks(codec_rank, 2, tmp_path, "dac", models, x, OVERRIDES, [True, False],
                        draws)
    mesh = jax_make_mesh(n_data=2, devices=jax.devices()[:2])
    tx = jaudio.make_audio_optimizer(LR)
    jstate = jvqgan.create_vqgan_state(s["jparams"], tx)
    jstep = jaudio.make_audio_train_step(s["jcodec"], tx, s["jcfg"], donate=False, mesh=mesh)
    jstate, jaux, jidx = jax.block_until_ready(jstep(jstate, jnp.asarray(x), key))
    both = ranks.join()
    res, cut = [r[0] for r in both], [r[1] for r in both]
    np.testing.assert_array_equal(np.concatenate([r["idx"] for r in res]), np.asarray(jidx))
    ref, ref_mu = _jax_codec_flat(jstate.params), _jax_moments(jstate.opt_g, "")
    for r in res:
        for k in jaux:
            np.testing.assert_allclose(r["aux"][k], float(jaux[k]), atol=1e-4, err_msg=k)
        assert_updated(r["codec"], ref, ref_mu, "codec")
        _assert_grads(r["mu"], ref_mu, "codec gradient")

    # mutation: no mesh, so no cross-rank statistics, broadcast or mean
    with pytest.raises(AssertionError):
        for r in cut:
            _assert_grads(r["mu"], ref_mu, "codec gradient")
