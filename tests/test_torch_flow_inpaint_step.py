"""One inpainting flow step of the port against the JAX package's: a
mask-conditioned U-Net (dim 8, dim_mults (1, 2), 8×8×4 latents) and a
``MaskEncoder`` (32² pixel masks, resized to the latents), the OTF
curriculum past its ramp (a quarter of the batch made unconditional from
``blank_latents``, a quarter identity), the mask identity loss, the two
optimizer groups (the mask encoder's at 0.1× the rate, clipped at 0.5) and
the EMA. The draws are injected: the noise, t, CFG noise, the OTF
permutation and the drop gate that ``jax.random`` drew under the JAX
step's own key split; once with the gate closed and once open (source and
mask replaced by noise and ones).

Compared: the losses (1e-4), the global gradient norm (1e-4 relative),
Adam's first moments of both groups in optax's ``multi_transform``
layout, as the port's checkpoints write them (1e-4 · the largest |ref| of
the tree plus 1e-3 relative), and what the step changed: each parameter's
change against the JAX change within 1e-2 of its group's rate (the recipe's
1e-4 for the U-Net, 0.1× that for the mask encoder), widened by
rate·eps/(|g| + eps) where the gradient g nears Adam's eps, plus two
float32 spacings of the parameter; and each EMA change the same way with
(1 − decay) times that rate, at an EMA decay of 0.9 so that the EMA moves
by a tenth of the step. Adam's first step moves an element by
lr·g/(|g| + eps), a whole rate wherever |g| ≫ eps, so a missing update, a
wrong group rate or a missing EMA update is tens of times the tolerance;
the JAX change is checked to be that large. An element whose gradient is so near 0 that the
two packages' first moments differ in sign moves the other way: those
elements (fewer than 0.1% of the parameters) are left out of the change
comparison, and counted. Also the curriculum's counts against the JAX
step's formula over three epochs' schedules.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flocoder_torch.inpainting import MaskEncoder, generate_mask_batch
from flocoder_torch.models.layers import init_params
from flocoder_torch.models.unet import Unet
from flocoder_torch.train_flow import _opt_flat, _params_flat
from flocoder_torch.training import flow as tflow
from flocoder_tpu.inpainting import MaskEncoder as JaxMaskEncoder
from flocoder_tpu.models.unet import Unet as JaxUnet
from flocoder_tpu.training import flow as jflow
from flocoder_tpu.training.checkpoint import flatten_tree, unflatten_tree

ATOL = 1e-4
B, S, C, P = 8, 8, 4, 32
LR = 1e-4          # midi_vqgan's flow rate (configs/common/flow.yaml)
MASK_LR = 0.1 * LR  # the mask encoder's group
EMA_DECAY = 0.9
ADAM_B1, ADAM_EPS = 0.9, 1e-8   # optax.adam's defaults, which both steps use
OTF = {"curriculum_epochs": 1, "extend_epochs": 3, "p_ones": 0.25, "p_zeros": 0.25,
       "steps_per_epoch": 1}
STEP = 5          # epoch 6: past the ramp, p_ones = p_zeros = 0.25


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nets():
    unet = init_params(Unet(dim=8, channels=C, dim_mults=(1, 2), mask_cond=True,
                            mask_channels=C), torch.Generator().manual_seed(0))
    me = init_params(MaskEncoder(output_channels=C, target_hw=(S, S)),
                     torch.Generator().manual_seed(1))
    return unet, me


def _batch():
    rng = np.random.default_rng(3)
    target = (rng.normal(size=(B, S, S, C)) * 0.7 + 0.2).astype(np.float32)
    source = (target * 0.5 + rng.normal(size=target.shape) * 0.3).astype(np.float32)
    masks = generate_mask_batch((P, P), B, seed=11)
    cc = np.zeros(B, np.int32)
    blank = rng.normal(size=(1, S, S, C)).astype(np.float32)
    jb = {"target": jnp.asarray(target), "source": jnp.asarray(source),
          "mask_pixels": jnp.asarray(masks), "class_cond": jnp.asarray(cc)}
    tb = {"target": torch.from_numpy(target), "source": torch.from_numpy(source),
          "mask_pixels": torch.from_numpy(masks), "class_cond": torch.from_numpy(cc).long()}
    return jb, tb, blank


def _jax_draws(rng):
    """The drop gate and the draws of JAX's step under ``rng``."""
    k_gate, k_body = jax.random.split(rng)
    k_noise, k_cfgnoise, k_t, k_otf = jax.random.split(k_body, 4)
    shape = (B, S, S, C)
    d = {"noise": jax.random.normal(k_noise, shape),
         "t_uniform": jax.random.uniform(k_t, (B,)),
         "cfg_noise": jax.random.normal(k_cfgnoise, shape),
         "otf_perm": jax.random.permutation(k_otf, B)}
    return bool(jax.random.uniform(k_gate) < 0.1), {
        k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _key_with_gate(open_gate: bool):
    for s in range(200):
        rng = jax.random.PRNGKey(s)
        if _jax_draws(rng)[0] == open_gate:
            return rng
    raise AssertionError("no key")


def _scale(tree: dict) -> float:
    return max(float(np.abs(np.asarray(v)).max()) for v in tree.values() if np.asarray(v).size)


def _mu_key(param_key: str) -> str:
    group = "model" if param_key.startswith("model/") else "mask"
    return f"inner_states/{group}/inner_state/1/0/mu/{param_key}"


def _close(ours: dict, ref: dict, what: str) -> None:
    """1e-4 · the largest |ref| plus 1e-3 relative."""
    assert set(ours) == set(ref), (what, sorted(set(ours) ^ set(ref))[:5])
    scale = _scale(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(np.asarray(ours[k]), np.asarray(v), atol=ATOL * scale,
                                   rtol=1e-3, err_msg=f"{what} {k}")


def _changes_close(ours: dict, ref: dict, before: dict, mu: tuple, share: float,
                   what: str) -> int:
    """The change ``ours - before`` against ``ref - before``, within
    ``share`` times the group's rate times 1e-2 + eps/(|g| + eps), plus two
    float32 spacings of the value, where the two first moments ``mu`` (ours,
    the reference's) agree in sign. Adam's first step lr·g/(|g| + eps) is a
    whole rate wherever |g| ≫ eps; where |g| nears eps it changes with g's
    last digits by up to rate·eps/(|g| + eps). The reference's median change
    in each group must be at least half its rate. Returns the number of
    elements left out."""
    assert set(ours) == set(ref) == set(before), what
    skipped, moved = 0, {}
    for k, v in ref.items():
        rate = share * (LR if k.startswith("model/") else MASK_LR)
        b = np.asarray(before[k], np.float64)
        r, o = np.asarray(v), np.asarray(ours[k])
        same = np.sign(np.asarray(mu[0][_mu_key(k)])) == np.sign(np.asarray(mu[1][_mu_key(k)]))
        skipped += int((~same).sum())
        d_ref, d_ours = (r - b)[same], (o - b)[same]
        g = np.abs(np.asarray(mu[1][_mu_key(k)], np.float64))[same] / (1 - ADAM_B1)
        tol = (rate * (1e-2 + ADAM_EPS / (g + ADAM_EPS))
               + 2 * np.spacing(np.abs(r[same]).astype(np.float32)))
        assert np.all(np.abs(d_ours - d_ref) <= tol), (
            f"{what} {k}: worst |Δ ours − Δ ref| {np.abs(d_ours - d_ref).max():.3e}, "
            f"rate {rate:.1e}")
        moved.setdefault(rate, []).append(np.abs(d_ref))
    for rate, d in moved.items():
        assert np.median(np.concatenate(d)) >= 0.5 * rate, (what, rate)
    return skipped


def test_inpainting_otf_step_matches_jax():
    unet, me = _nets()
    jb, tb, blank = _batch()
    jparams = unflatten_tree({k: jnp.asarray(v) for k, v in _params_flat(unet, me).items()})
    ju = JaxUnet(dim=8, channels=C, dim_mults=(1, 2), mask_cond=True, mask_channels=C)
    jm = JaxMaskEncoder(output_channels=C, target_hw=(S, S))
    tx = jflow.make_flow_optimizer(LR, mask_encoder=True)
    jstep = jflow.make_flow_train_step(
        lambda p, x, t, c: ju.apply(p, x, t, c), tx,
        mask_encoder_apply=lambda p, m: jm.apply(p, m),
        blank_latents=jnp.asarray(blank), otf_aug=OTF, ema_decay=EMA_DECAY)
    tstep = tflow.make_flow_train_step(blank_latents=torch.from_numpy(blank), otf_aug=OTF,
                                       ema_decay=EMA_DECAY)
    before = {k: np.asarray(v) for k, v in _params_flat(unet, me).items()}
    n1, n0 = tflow.otf_counts(OTF, STEP, B)
    assert (n1, n0) == (2, 2)
    for open_gate in (False, True):
        rng = _key_with_gate(open_gate)
        jstate = jflow.create_flow_state(jparams, tx).replace(step=jnp.asarray(STEP, jnp.int32))
        jstate, jaux = jstep(jstate, jb, rng)
        jax.block_until_ready(jstate)
        drop, draws = _jax_draws(rng)
        u, m = _nets()
        state = tflow.create_flow_state(u, LR, mask_encoder=m)
        state.step = STEP
        state, aux = tstep(state, tb, torch.Generator(), draws=[draws],
                           drop=torch.tensor(drop))
        for k in ("loss", "loss_flow", "loss_mask"):
            np.testing.assert_allclose(float(aux[k]), float(jaux[k]), atol=ATOL,
                                       err_msg=f"{k} gate {open_gate}")
        np.testing.assert_allclose(float(aux["grad_norm"]), float(jaux["grad_norm"]),
                                   rtol=1e-4)
        jopt = {k: v for k, v in flatten_tree(jstate.opt_state).items() if "/mu/" in k}
        topt = {k: v for k, v in _opt_flat(state).items() if "/mu/" in k}
        _close(topt, jopt, f"mu gate {open_gate}")
        n = sum(v.size for v in before.values())
        for ours, theirs, share, what in (
                (_params_flat(state.model, state.mask_encoder), flatten_tree(jstate.params),
                 1.0, "params"),
                (_params_flat(state.ema, state.ema_mask_encoder), flatten_tree(jstate.ema),
                 1.0 - EMA_DECAY, "ema")):
            skipped = _changes_close(ours, theirs, before, (topt, jopt), share,
                                     f"{what} gate {open_gate}")
            assert skipped < n // 1000, (what, skipped, n)
        assert state.step == STEP + 1


def _jax_counts(otf, step, b):
    """The curriculum of the JAX step (training/flow.py:180-196), on jnp."""
    ce, ee = float(otf["curriculum_epochs"]), float(otf["extend_epochs"])
    ep = (jnp.asarray(step, jnp.int32) // otf["steps_per_epoch"] + 1).astype(jnp.float32)
    prog = jnp.clip((ep - ce) / jnp.maximum(ee - ce, 1.0), 0.0, 1.0)
    p1 = jnp.where(ep <= ce, (ce - (ep - 1.0)) / jnp.maximum(ce, 1.0),
                   jnp.where(ep <= ee, 0.1 + 0.2 * prog, otf["p_ones"]))
    p0 = jnp.where(ep <= ce, 0.0, jnp.where(ep <= ee, 0.02 * prog, otf["p_zeros"]))
    return int(jnp.floor(p1 * b)), int(jnp.floor(p0 * b))


@pytest.mark.parametrize("otf", [
    OTF, {"curriculum_epochs": 3, "extend_epochs": 7, "p_ones": 0.1, "p_zeros": 0.05,
          "steps_per_epoch": 4},
    {"curriculum_epochs": 0, "extend_epochs": 0, "p_ones": 0.3, "p_zeros": 0.1,
     "steps_per_epoch": 2}])
def test_otf_counts_follow_the_jax_curriculum(otf):
    for step in range(0, 40):
        for b in (8, 256, 2048):
            assert tflow.otf_counts(otf, step, b) == _jax_counts(otf, step, b), (step, b)
