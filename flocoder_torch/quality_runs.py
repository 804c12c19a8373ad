"""Converged-quality runs of the model families on synthetic tasks with a
known answer, on the card: the port's twin of ``tools/quality_runs.py``.

Each family trains to its loss floor on seeded synthetic data and scores
what it samples against held-out data, so quality is measurable without a
dataset or pretrained weights:
- ``unet_vs_hdit``: two-cluster latents (8×8×2; class 0 at −1.5, class 1
  at +1.5, σ 0.1). The U-Net and HDiT (global attention) at an equal step
  budget, and HDiT at ``hdit_budget_x`` times it: loss floor, latent
  Sinkhorn divergence to held-out data, class separation and centre error
  of RK4-50 + CFG samples.
- ``meanflow``: 1-NFE MeanFlow against the same budget's flow at RK4-50.
- ``reflow``: a base flow's RK4-50 (noise, sample) pairs train a reflow
  model; Euler-5 (4 NFE) quality of both.
- ``audio``: the DAC codec on 8 kHz harmonic mixtures, reconstruction then
  adversarial phase: loss floors, SNR and mel loss on a held-out batch.
- ``image``: 64² coloured blobs (3 classes) → the resize codec → 16×16×4
  latents: U-Net, MeanFlow, reflow and HDiT scored in pixels (FID on the
  features ``ops/fid.default_feature_fn`` picks, pixel and latent
  Sinkhorn, colour accuracy: the decoded image's dominant channel against
  its class).
- ``pod`` needs the 8-device mesh, expert and pipeline parallelism: it
  raises until those are ported (ROADMAP.md item 13c).

Each family trains on one device through ``training/flow.py``'s step (or
``training/audio.py``'s), draws its data with numpy exactly as the JAX
tool does for the same seeds, initialises its weights from a
``torch.Generator`` on the device, and writes ``<out>/<family>.json`` (the
JAX tool's payload keys, plus the sizes, the device and the JAX artifact
in ``eval_out/quality/`` it is read against), sample grids and, where
matplotlib is installed, loss curves. The JAX artifacts are never written.

Usage:
    python -m flocoder_torch.quality_runs [family ...] [--device cpu]
        [--out DIR] [--<family>-<size> N ...]

with the five families by default, the card unless ``--device cpu``,
``eval_out/quality_torch/`` by default, and one flag for each size
argument of a family, e.g. ``--image-steps 800 --image-reflow-steps 400``.
"""
from __future__ import annotations

import argparse
import copy
import inspect
import json
import os
import subprocess
import time

import numpy as np
import torch

from .config import config_from_dict
from .data.datasets import SyntheticImageDataset
from .metrics import compute_sample_metrics, to_uint8
from .models.audio_codec import DACCodec
from .models.audio_disc import DACDiscriminator
from .models.codecs import SimpleResizeAE
from .models.hdit import HDiT, GlobalAttentionSpec, LevelSpec, MappingSpec
from .models.layers import init_params
from .models.unet import Unet
from .ops.audio import multiscale_mel_loss
from .ops.fid import default_feature_fn, feature_backend_name, fid_score
from .ops.sinkhorn import sinkhorn_divergence
from .sampling import generate_latents
from .training.audio import create_audio_state, make_audio_gan_step, make_audio_train_step
from .training.flow import create_flow_state, make_flow_train_step
from .utils.device import resolve_device
from .utils.viz import make_grid, save_img

__all__ = ["FAMILIES", "run_unet_vs_hdit", "run_meanflow", "run_reflow", "run_audio",
           "run_pod", "run_image", "img_quality", "main"]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "eval_out", "quality_torch")
JAX_ARTIFACTS = "eval_out/quality"

H, W, C, N_CLASSES = 8, 8, 2, 2
CENTERS = (-1.5, 1.5)
SIGMA = 0.1
# The JAX tool trains on an 8-device mesh whose step pairs OT within each
# device's shard of the batch (flocoder_tpu/training/flow.py: "OT pairing
# then runs PER SHARD"); on one device the same pairing is OT within
# aligned blocks of B/8 (``ot_block``).
MESH_SHARDS = 8


def _make_batch(rng, b=64, h=H, w=W, c=C, balanced=False):
    # balanced=True: exactly b/2 per class, so that a Sinkhorn comparison
    # measures the clusters' shape and not the class counts' noise
    if balanced:
        cls = rng.permutation(np.arange(b) % N_CLASSES)
    else:
        cls = rng.integers(0, N_CLASSES, size=b)
    centers = np.where(cls[:, None, None, None] == 0, CENTERS[0], CENTERS[1])
    lat = centers + SIGMA * rng.standard_normal((b, h, w, c))
    return {"target": lat.astype(np.float32), "class_cond": cls.astype(np.int32)}


def _to_device(raw: dict, device) -> dict:
    return {k: torch.as_tensor(v).to(device, torch.long if k == "class_cond" else None)
            for k, v in raw.items()}


def _train(model, steps, seed=0, b=64, h=H, w=W, c=C, lr=3e-3, snapshot_at=None,
           batch_fn=None, draws_fn=None, **step_kw):
    """Trains ``model`` in place for ``steps`` steps of
    ``make_flow_train_step(**step_kw)``, OT pairing within blocks of
    ``b // MESH_SHARDS`` as the JAX tool's mesh pairs it, on the default
    two-cluster batches (or ``batch_fn(rng) -> batch dict`` of ``b``), the
    numpy batches drawn from ``seed`` and the step's draws from a generator
    seeded ``seed + 1`` on the model's device. ``draws_fn(i) -> (draws,
    drop)`` injects step ``i``'s draws and CFG gate instead. Returns
    ``(state, losses)``, and with ``snapshot_at`` also a copy of the model
    after that many steps."""
    device = next(model.parameters()).device
    state = create_flow_state(model, lr)
    step = make_flow_train_step(ot_block=b // MESH_SHARDS, **step_kw)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device).manual_seed(seed + 1)
    losses, snap = [], None
    for i in range(steps):
        raw = (batch_fn(rng) if batch_fn is not None
               else _make_batch(rng, b=b, h=h, w=w, c=c))
        draws, drop = draws_fn(i) if draws_fn is not None else (None, None)
        state, aux = step(state, _to_device(raw, device), gen,
                          draws=None if draws is None else [draws], drop=drop)
        losses.append(aux["loss"])
        if snapshot_at and (i + 1) == snapshot_at:
            snap = copy.deepcopy(state.model)
    losses = torch.stack(losses).tolist() if losses else []
    if snapshot_at:
        return state, losses, snap
    return state, losses


@torch.no_grad()
def _quality(samp_apply, rng_np, method="rk4", n_steps=50, b=64, t_scale=999.0, h=H,
             w=W, c=C, cfg_strength=2.0, device=None, noise=None):
    """Samples b latents (half class 0, half class 1) from ``noise`` (by
    default drawn from a generator seeded 5 on ``device``) and scores them:
    latent Sinkhorn divergence to a fresh balanced data batch, class-mean
    separation and the class means' error against the true centres."""
    device = torch.device(device or "cpu")
    cond = {"class_cond": torch.tensor([0] * (b // 2) + [1] * (b // 2), device=device),
            "mask_cond": None}
    lat, nfe = generate_latents(samp_apply, (b, h, w, c),
                                torch.Generator(device).manual_seed(5), method=method,
                                n_steps=n_steps, cond=cond, cfg_strength=cfg_strength,
                                t_scale=t_scale, source=noise, device=device)
    data = _make_batch(rng_np, b=b, h=h, w=w, c=c, balanced=True)["target"]
    sink = float(sinkhorn_divergence(lat.reshape(b, -1),
                                     torch.from_numpy(data.reshape(b, -1)).to(device),
                                     blur=0.05))
    lat = lat.float().cpu().numpy()
    m0 = float(lat[: b // 2].mean())
    m1 = float(lat[b // 2:].mean())
    return {"nfe": int(nfe), "sinkhorn_latent": round(sink, 4),
            "class0_mean": round(m0, 3), "class1_mean": round(m1, 3),
            "center_abs_err": round(0.5 * (abs(m0 - CENTERS[0])
                                           + abs(m1 - CENTERS[1])), 3),
            "separation": round(m1 - m0, 3)}, lat


def _save_curve(losses_by_name: dict, path: str, title: str):
    try:
        import matplotlib
    except ImportError:
        print(f"matplotlib is not installed: {os.path.basename(path)} not drawn "
              "(the JSON holds the curves)")
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(6, 3.5))
    for name, ls in losses_by_name.items():
        ax.plot(np.arange(1, len(ls) + 1), ls, label=name, linewidth=1.2)
    ax.set_yscale("log")
    ax.set_xlabel("step")
    ax.set_ylabel("train loss")
    ax.set_title(title)
    ax.legend(frameon=False)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def _save_grid(lat: np.ndarray, path: str):
    # channel-0 grayscale panels; latents centred at ±1.5 map to [0, 1]
    imgs = np.clip((lat[..., :1] + 2.0) / 4.0, 0, 1)
    save_img(make_grid(imgs, ncols=8), path)


def _floor(losses, tail=50):
    return round(float(np.mean(losses[-tail:])), 4)


def _curve(losses, every=25):
    return [round(float(v), 4) for v in losses[::every]]


def _device_record(device: torch.device) -> dict:
    """The device a payload was measured on; for the card its name and power
    limit as nvidia-smi prints them."""
    if device.type != "cuda":
        return {"type": device.type}
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        smi = None
    return {"type": "cuda", "name": torch.cuda.get_device_name(device), "nvidia_smi": smi}


def _write(family: str, payload: dict, out: str):
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, f"{family}.json")
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
    print(f"[{family}] {json.dumps(payload['summary'])}\n  -> {path}", flush=True)


def _meta(family: str, device: torch.device, **sizes) -> dict:
    return {"sizes": sizes, "device": _device_record(device),
            "jax_artifact": f"{JAX_ARTIFACTS}/{family}.json"}


def _init_params(model: torch.nn.Module, device, seed: int = 0) -> torch.nn.Module:
    """Seeded random init on ``device``; every flow model of a family is
    seeded alike, as the JAX tool initialises each from PRNGKey(0)."""
    model = model.to(device)
    return init_params(model, torch.Generator(device).manual_seed(seed))


def _unet(dim=H, n_classes=N_CLASSES, dual_time=False, device=None):
    return _init_params(Unet(dim=dim, dim_mults=(1, 2), channels=C, n_classes=n_classes,
                             dual_time=dual_time), device)


def _hdit(channels: int, n_classes: int, device):
    return _init_params(HDiT(levels=(LevelSpec(2, 32, 96, GlobalAttentionSpec(16)),
                                     LevelSpec(2, 64, 192, GlobalAttentionSpec(16))),
                             mapping=MappingSpec(2, 64, 192), channels=channels,
                             patch_size=2, n_classes=n_classes), device)


@torch.no_grad()
def _data_sinkhorn_baseline(rng, b=64, h=H, w=W, c=C, device=None):
    """Sinkhorn divergence between two independent data batches: the noise
    floor every generated-against-data divergence is read against."""
    a = _make_batch(rng, b=b, h=h, w=w, c=c, balanced=True)["target"].reshape(b, -1)
    d = _make_batch(rng, b=b, h=h, w=w, c=c, balanced=True)["target"].reshape(b, -1)
    dev = torch.device(device or "cpu")
    return round(float(sinkhorn_divergence(torch.from_numpy(a).to(dev),
                                           torch.from_numpy(d).to(dev), blur=0.05)), 4)


def _applier(model):
    model.eval()
    return lambda x, t, c: model(x, t, c)


def run_unet_vs_hdit(steps=800, hdit_budget_x=3, eval_steps=50, *, device=None, out=OUT):
    """The U-Net at ``steps``; HDiT at the same budget (a snapshot) and at
    ``hdit_budget_x`` times it, where the JAX tool found HDiT's
    multiplicative conditioning picks up class control. No OT pairing: on
    separated clusters it makes the class label redundant for the loss."""
    device = resolve_device(device)
    t0 = time.time()
    unet = _unet(device=device)
    u_state, u_losses = _train(unet, steps, use_ot=False)

    hdit = _hdit(C, N_CLASSES, device)
    h_state, h_losses, h_snap = _train(hdit, steps * hdit_budget_x, lr=1e-3,
                                       use_ot=False, snapshot_at=steps)

    rng = np.random.default_rng(99)
    q = dict(n_steps=eval_steps, device=device)
    u_q, u_lat = _quality(_applier(u_state.model), rng, **q)
    h_q_eq, _ = _quality(_applier(h_snap), rng, **q)
    h_q, h_lat = _quality(_applier(h_state.model), rng, **q)
    os.makedirs(out, exist_ok=True)
    _save_curve({"unet": u_losses, "hdit": h_losses},
                os.path.join(out, "unet_vs_hdit_loss.png"),
                f"U-Net vs HDiT, {steps} steps, B=64 (synthetic latents)")
    _save_grid(u_lat, os.path.join(out, "unet_samples.png"))
    _save_grid(h_lat, os.path.join(out, "hdit_samples.png"))
    _write("unet_vs_hdit", {
        "note": "curves downsampled every 25 steps",
        "unet_loss_curve": _curve(u_losses),
        "hdit_loss_curve": _curve(h_losses),
        "task": "two-cluster synthetic latents 8x8x2, equal budget",
        "steps": steps, "batch": 64,
        "summary": {"unet_loss_floor": _floor(u_losses),
                    "hdit_loss_floor": _floor(h_losses),
                    "data_vs_data_sinkhorn": _data_sinkhorn_baseline(rng, device=device),
                    "unet_rk4_50": u_q,
                    "hdit_rk4_50_equal_budget": h_q_eq,
                    "hdit_rk4_50_converged": h_q},
        **_meta("unet_vs_hdit", device, steps=steps, hdit_budget_x=hdit_budget_x,
                eval_steps=eval_steps),
        "wall_s": round(time.time() - t0, 1)}, out)


def run_meanflow(steps=600, eval_steps=50, *, device=None, out=OUT):
    """1-NFE MeanFlow against the same budget's flow sampled at RK4-50."""
    device = resolve_device(device)
    t0 = time.time()
    base = _unet(device=device)
    b_state, b_losses = _train(base, steps)
    mf = _unet(dual_time=True, device=device)
    m_state, m_losses = _train(mf, steps, meanflow=True, t_scale=1.0)

    rng = np.random.default_rng(98)
    b_q, b_lat = _quality(_applier(b_state.model), rng, method="rk4", n_steps=eval_steps,
                          device=device)
    # cfg_strength 0: guidance is trained into the average-velocity field;
    # CFG on top of it over-extrapolates
    m_q, m_lat = _quality(_applier(m_state.model), rng, method="meanflow", n_steps=1,
                          t_scale=1.0, cfg_strength=0.0, device=device)
    os.makedirs(out, exist_ok=True)
    _save_curve({"flow (rk4 eval)": b_losses, "meanflow": m_losses},
                os.path.join(out, "meanflow_loss.png"),
                f"standard vs MeanFlow objective, {steps} steps")
    _save_grid(m_lat, os.path.join(out, "meanflow_1nfe_samples.png"))
    _write("meanflow", {
        "flow_loss_curve": _curve(b_losses),
        "meanflow_loss_curve": _curve(m_losses),
        "task": "two-cluster synthetic latents, equal budget",
        "steps": steps, "batch": 64,
        "summary": {"flow_loss_floor": _floor(b_losses),
                    "meanflow_loss_floor": _floor(m_losses),
                    "data_vs_data_sinkhorn": _data_sinkhorn_baseline(rng, device=device),
                    "rk4_50": b_q, "meanflow_1nfe": m_q},
        **_meta("meanflow", device, steps=steps, eval_steps=eval_steps),
        "wall_s": round(time.time() - t0, 1)}, out)


@torch.no_grad()
def _pairs(apply, n_batches: int, seed0: int, shape: tuple, n_classes: int,
           eval_steps: int, device) -> list:
    """(noise, RK4 + CFG 2.0 sample, class) batches of the base model, the
    noise of batch i drawn from a generator seeded ``seed0 + i``, the
    classes balanced."""
    b = shape[0]
    cls = torch.arange(b, device=device) % n_classes
    pairs = []
    for i in range(n_batches):
        gen = torch.Generator(device).manual_seed(seed0 + i)
        noise = torch.randn(shape, generator=gen, device=device)
        lat, _ = generate_latents(apply, shape, gen, method="rk4", n_steps=eval_steps,
                                  cond={"class_cond": cls, "mask_cond": None},
                                  cfg_strength=2.0, source=noise, device=device)
        pairs.append((noise, lat, cls))
    return pairs


def run_reflow(steps=400, pair_batches=24, eval_steps=50, *, device=None, out=OUT):
    """Base flow → (noise, sample) pairs of its RK4-50 → reflow training →
    few-step Euler quality of both."""
    device = resolve_device(device)
    t0 = time.time()
    base = _unet(device=device)
    b_state, b_losses = _train(base, steps)
    b_apply = _applier(b_state.model)
    pairs = _pairs(b_apply, pair_batches, 1000, (64, H, W, C), N_CLASSES, eval_steps,
                   device)

    re = _unet(device=device)
    r_state = create_flow_state(re, 3e-3)
    r_step = make_flow_train_step(paired_source=True)
    gen = torch.Generator(device).manual_seed(77)
    r_losses = []
    for s in range(steps):
        src, tgt, cls = pairs[s % len(pairs)]
        r_state, aux = r_step(r_state, {"source": src, "target": tgt, "class_cond": cls},
                              gen)
        r_losses.append(aux["loss"])
    r_losses = torch.stack(r_losses).tolist() if r_losses else []

    rng = np.random.default_rng(97)
    base_e5, _ = _quality(b_apply, rng, method="euler", n_steps=5, device=device)
    # the base model's own unguided few-step run, so that the comparison is
    # not confounded by CFG 2.0's distortion
    base_e5_cfg0, _ = _quality(b_apply, rng, method="euler", n_steps=5, cfg_strength=0.0,
                               device=device)
    base_rk4, _ = _quality(b_apply, rng, method="rk4", n_steps=eval_steps, device=device)
    # cfg_strength 0: the pairs came from CFG-guided trajectories, so the
    # learned conditional map is the guided one already
    re_e5, re_lat = _quality(_applier(r_state.model), rng, method="euler", n_steps=5,
                             cfg_strength=0.0, device=device)
    os.makedirs(out, exist_ok=True)
    _save_curve({"base": b_losses, "reflow": r_losses},
                os.path.join(out, "reflow_loss.png"),
                "base flow vs reflow (paired) training")
    _save_grid(re_lat, os.path.join(out, "reflow_euler5_samples.png"))
    _write("reflow", {
        "base_loss_curve": _curve(b_losses),
        "reflow_loss_curve": _curve(r_losses),
        "task": "reflow pairs from base RK4-50; euler-5 serving quality",
        "steps": steps, "batch": 64, "pair_batches": pair_batches,
        "summary": {"base_loss_floor": _floor(b_losses),
                    "reflow_loss_floor": _floor(r_losses),
                    "data_vs_data_sinkhorn": _data_sinkhorn_baseline(rng, device=device),
                    "base_euler5": base_e5,
                    "base_euler5_cfg0": base_e5_cfg0,
                    "base_rk4_50": base_rk4,
                    "reflow_euler5": re_e5},
        **_meta("reflow", device, steps=steps, pair_batches=pair_batches,
                eval_steps=eval_steps),
        "wall_s": round(time.time() - t0, 1)}, out)


AUDIO_T = np.arange(2048) / 8000.0
AUDIO_CONFIG = {"codec": {"sample_rate": 8000, "fft_sizes": [64, 128, 256],
                          "n_mels": [8, 16, 32], "lambda_mel": 5.0,
                          "lambda_gen": 1.0, "lambda_feat": 2.0}}


def _wav_batch(rng, b=8) -> np.ndarray:
    """b harmonic mixtures (3 partials of a random f0 in 150–500 Hz, random
    amplitudes and phases), (b, 2048, 1) float32."""
    out = []
    for _ in range(b):
        f0 = rng.uniform(150, 500)
        amps = rng.uniform(0.1, 0.4, size=3)
        x = sum(a * np.sin(2 * np.pi * f0 * (k + 1) * AUDIO_T + rng.uniform(0, 6.28))
                for k, a in enumerate(amps))
        out.append(x)
    return np.stack(out).astype(np.float32)[..., None]


def run_audio(steps=800, gan_steps=800, *, device=None, out=OUT):
    """DAC codec convergence in both phases: the loss floors and the
    held-out batch's SNR and mel loss after the reconstruction phase, then
    the adversarial phase (period and scale waveform discriminators) with
    the same readings after it."""
    device = resolve_device(device)
    t0 = time.time()
    codec = DACCodec(sample_rate=8000, strides=(2, 4, 4), base_channels=16,
                     vq_embedding_dim=4, codebook_levels=2, vq_num_embeddings=32).to(device)
    cfg = config_from_dict(AUDIO_CONFIG)
    rng = np.random.default_rng(5)
    _wav_batch(rng, 2)          # the JAX tool's codec and discriminator inits
    _wav_batch(rng, 2)          # each take a batch of 2 from this stream
    codec.init(torch.Generator(device).manual_seed(0))
    disc = _init_params(DACDiscriminator(periods=(2, 3, 5), scales=2, base_channels=8),
                        device, seed=9)
    # lr 1e-3: at 3e-3 the JAX tool's run oscillated upward
    state = create_audio_state(codec, disc, 1e-3, d_lr_scale=1.0)
    step = make_audio_train_step(cfg)
    gen = torch.Generator(device).manual_seed(1)

    def batch():
        return torch.from_numpy(_wav_batch(rng)).to(device)

    totals, mels, aux = [], [], {}
    for _ in range(steps):
        state, aux, _ = step(state, batch(), gen)
        totals.append(aux["total"])
        mels.append(aux["mel"])
    recon_components = {k: round(float(v), 4) for k, v in aux.items()}
    totals = torch.stack(totals).tolist()
    mels = torch.stack(mels).tolist()
    x_hold = torch.from_numpy(_wav_batch(np.random.default_rng(7777), 8)).to(device)

    @torch.no_grad()
    def snr_mel():
        """Reconstruction SNR (dB) and mel loss on the held-out batch, the
        same waveforms before and after the adversarial phase."""
        recon = codec(x_hold, train=False)[0]
        x = x_hold.cpu().numpy()
        err = (recon - x_hold).cpu().numpy()
        snr = float(10 * np.log10(float(np.mean(x ** 2))
                                  / max(float(np.mean(err ** 2)), 1e-12)))
        mel = float(multiscale_mel_loss(x_hold[..., 0], recon[..., 0], 8000,
                                        fft_sizes=(64, 128, 256), n_mels=(8, 16, 32)))
        return round(snr, 2), round(mel, 4)

    snr_recon, mel_recon = snr_mel()
    gan_step = make_audio_gan_step(cfg)
    g_totals, g_mels, d_losses = [], [], []
    for _ in range(gan_steps):
        state, aux, _ = gan_step(state, batch(), gen)
        g_totals.append(aux["total"])
        g_mels.append(aux["mel"])
        d_losses.append(aux["d_loss"])
    gan_components = {k: round(float(v), 4) for k, v in aux.items()}
    g_mels = torch.stack(g_mels).tolist() if g_mels else []
    d_losses = torch.stack(d_losses).tolist() if d_losses else []
    snr_gan, mel_gan = snr_mel()

    os.makedirs(out, exist_ok=True)
    _save_curve({"total (recon)": totals, "mel (recon)": mels,
                 "mel (gan)": g_mels, "d_loss": d_losses},
                os.path.join(out, "audio_loss.png"),
                f"DAC codec: {steps} recon + {gan_steps} GAN steps")
    _write("audio", {
        "total_loss_curve": _curve(totals),
        "mel_loss_curve": _curve(mels),
        "gan_mel_curve": _curve(g_mels),
        "d_loss_curve": _curve(d_losses),
        "task": "harmonic mixtures 8 kHz, 2048-sample crops",
        "steps": steps, "gan_steps": gan_steps, "batch": 8,
        "summary": {"total_loss_floor": _floor(totals),
                    "mel_loss_floor": _floor(mels),
                    "first_loss": round(totals[0], 3),
                    "recon_snr_db": snr_recon,
                    "recon_mel": mel_recon,
                    "gan_snr_db": snr_gan,
                    "gan_mel": mel_gan,
                    "snr_gain_db": round(snr_gan - snr_recon, 2),
                    "recon_components": recon_components,
                    "gan_components": gan_components},
        **_meta("audio", device, steps=steps, gan_steps=gan_steps),
        "wall_s": round(time.time() - t0, 1)}, out)


def run_pod(epochs=120, interleaved_epochs=10, *, device=None, out=OUT):
    """``configs/tpu_pod_hdit.yaml`` end to end on an 8-device mesh with
    expert and pipeline parallelism: not ported yet."""
    raise NotImplementedError("the pod family needs the 8-device mesh, MoE expert "
                              "parallelism and pipeline parallelism, which are not "
                              "ported yet (ROADMAP.md item 13c)")


# ---------------------------------------------------------------------------
# The image task: the tpu_demo pipeline (coloured blobs → resize codec →
# 16×16×4 latents → flow → decode) scored in pixels.
# ---------------------------------------------------------------------------

IMG_CLASSES = 3     # one pure colour channel a class: conditional control is
                    # directly measurable as colour accuracy
IMG_SIZE = 64
LAT_H, LAT_C = 16, 4


def _image_bank(n=768, seed=0):
    """Deterministic coloured-blob images in [-1, 1], NHWC, and labels."""
    ds = SyntheticImageDataset(n=n, image_size=IMG_SIZE, n_classes=IMG_CLASSES, seed=seed)
    rng = np.random.default_rng(seed)
    imgs, labels = [], []
    for i in range(n):
        x, y = ds.get(i, rng)
        imgs.append(np.asarray(x, np.float32) * 2.0 - 1.0)
        labels.append(int(y))
    return np.stack(imgs), np.asarray(labels, np.int32)


def _save_grid_rgb(px: np.ndarray, path: str, ncols=8):
    save_img(make_grid(np.clip((px + 1.0) / 2.0, 0, 1), ncols=ncols), path)


def _balanced_cls(b):
    return np.asarray([i % IMG_CLASSES for i in range(b)], np.int32)


class ImageTask:
    """The image task's codec and its held-out split (latents, labels,
    pixels) on ``device``."""

    def __init__(self, codec, lat_ev, lab_ev, img_ev, device):
        self.codec, self.device = codec, device
        self.lat_ev, self.lab_ev, self.img_ev = lat_ev, lab_ev, img_ev

    def eval_batch(self, rng, n=96):
        """A class-balanced held-out draw (latents, pixels)."""
        out = []
        for cls in range(IMG_CLASSES):
            pool = np.where(self.lab_ev == cls)[0]
            out.append(rng.choice(pool, size=n // IMG_CLASSES,
                                  replace=len(pool) < n // IMG_CLASSES))
        idx = np.concatenate(out)
        return self.lat_ev[idx], self.img_ev[idx]


@torch.no_grad()
def img_quality(samp_apply, task: ImageTask, feature_fn, method="rk4", n_steps=50,
                cfg_strength=2.0, t_scale=999.0, n=96, seed=11, noise=None):
    """Samples n latents (classes balanced) from ``noise`` (by default drawn
    from a generator seeded ``seed``), decodes them and scores them against
    a held-out draw: pixel FID, latent and pixel Sinkhorn, colour accuracy.
    Returns the scores and the decoded images."""
    dev = task.device
    cls = torch.from_numpy(_balanced_cls(n)).to(dev, torch.long)
    lat, nfe = generate_latents(samp_apply, (n, LAT_H, LAT_H, LAT_C),
                                torch.Generator(dev).manual_seed(seed), method=method,
                                n_steps=n_steps, cond={"class_cond": cls, "mask_cond": None},
                                cfg_strength=cfg_strength, t_scale=t_scale, source=noise,
                                device=dev)
    dec = task.codec.decode(lat)
    r_lat, r_px = task.eval_batch(np.random.default_rng(seed + 1), n)
    m = compute_sample_metrics(lat, torch.from_numpy(r_lat).to(dev), dec,
                               torch.from_numpy(r_px).to(dev), feature_fn=feature_fn)
    dec = dec.float().cpu().numpy()
    # colour accuracy: the decoded image's dominant channel against its class
    energy = ((dec + 1.0) / 2.0).mean(axis=(1, 2))
    acc = float(np.mean(np.argmax(energy, axis=1) == _balanced_cls(n)))
    return {"nfe": int(nfe),
            "fid_px": round(float(m["FID_px"]), 2),
            "sinkhorn_latent": round(float(m["sinkhorn"]), 4),
            "sinkhorn_px": round(float(m["sinkhorn_px"]), 4),
            "color_acc": round(acc, 3)}, dec


def _image_unet(dual_time=False, device=None):
    return _init_params(Unet(dim=LAT_H, dim_mults=(1, 2, 4, 8), channels=LAT_C,
                             n_classes=IMG_CLASSES, dual_time=dual_time), device)


def run_image(steps=600, hdit_budget_x=3, reflow_steps=300, pair_batches=8, eval_steps=50,
              *, device=None, out=OUT, feature_fn=None):
    """The tpu_demo pipeline as a quality gate: on one pre-encoded latent
    bank of coloured blobs, with OT pairing on, the U-Net (dim 16), a
    dual-time U-Net trained as MeanFlow and sampled in 1 NFE, a reflow of
    the U-Net's RK4-50 pairs served at Euler-5, and HDiT at the same budget
    and at ``hdit_budget_x`` times it, each scored in pixels
    (``img_quality``). ``feature_fn`` defaults to
    ``ops/fid.default_feature_fn`` (rp2048 unless weights/fid_inception.npz
    exists under the working directory); the payload names the backend. The
    JSON is rewritten after every family."""
    device = resolve_device(device)
    t0 = time.time()
    codec = SimpleResizeAE(latent_shape=(LAT_H, LAT_H, LAT_C), image_size=IMG_SIZE)
    imgs, labels = _image_bank()
    with torch.no_grad():
        lats = np.concatenate([codec.encode(torch.from_numpy(imgs[i:i + 128]).to(device))
                               .cpu().numpy() for i in range(0, len(imgs), 128)])
    n_train = 640
    lat_tr, lab_tr = lats[:n_train], labels[:n_train]
    task = ImageTask(codec, lats[n_train:], labels[n_train:], imgs[n_train:], device)
    feature_fn = feature_fn or default_feature_fn(image_size=IMG_SIZE)

    b = 64

    def batch_fn(rng):
        idx = rng.integers(0, n_train, size=b)
        return {"target": lat_tr[idx], "class_cond": lab_tr[idx]}

    # data-against-data noise floors for the FID and Sinkhorn readings
    a_lat, a_px = task.eval_batch(np.random.default_rng(500), 96)
    d_lat, d_px = task.eval_batch(np.random.default_rng(501), 96)
    with torch.no_grad():
        fid_base = round(float(fid_score(to_uint8(torch.from_numpy(a_px).to(device)),
                                         to_uint8(torch.from_numpy(d_px).to(device)),
                                         feature_fn=feature_fn)), 2)
        sink_base = round(float(sinkhorn_divergence(
            torch.from_numpy(a_lat.reshape(96, -1)).to(device),
            torch.from_numpy(d_lat.reshape(96, -1)).to(device), blur=0.05)), 4)
    os.makedirs(out, exist_ok=True)
    _save_grid_rgb(a_px[:24], os.path.join(out, "image_real.png"))

    summary = {"fid_data_vs_data": fid_base, "sinkhorn_data_vs_data": sink_base}
    payload = {
        "task": "tpu_demo pipeline at CPU scale: 64² synthetic colored-"
                "blob images (3 classes) -> resize codec -> 16x16x4 "
                "latents -> flow -> decode -> pixel metrics",
        "steps": steps, "batch": b, "hdit_steps": steps * hdit_budget_x,
        "reflow_steps": reflow_steps, "summary": summary,
        "fid_backend": feature_backend_name(feature_fn),
        **_meta("image", device, steps=steps, hdit_budget_x=hdit_budget_x,
                reflow_steps=reflow_steps, pair_batches=pair_batches,
                eval_steps=eval_steps)}

    def emit():
        payload["wall_s"] = round(time.time() - t0, 1)
        _write("image", payload, out)

    # ---- the base U-Net ----------------------------------------------------
    unet = _image_unet(device=device)
    u_state, u_losses = _train(unet, steps, lr=1e-3, batch_fn=batch_fn)
    u_apply = _applier(u_state.model)
    u_q, u_dec = img_quality(u_apply, task, feature_fn, n_steps=eval_steps)
    _save_grid_rgb(u_dec[:24], os.path.join(out, "image_unet_rk4.png"))
    print(f"[image] unet {u_q} ({time.time() - t0:.0f}s)", flush=True)
    payload["unet_loss_curve"] = _curve(u_losses)
    summary["unet_loss_floor"] = _floor(u_losses)
    summary["unet_rk4_50"] = u_q
    emit()

    # ---- MeanFlow, 1 NFE ---------------------------------------------------
    mf = _image_unet(dual_time=True, device=device)
    m_state, m_losses = _train(mf, steps, lr=1e-3, batch_fn=batch_fn, meanflow=True,
                               t_scale=1.0)
    m_q, m_dec = img_quality(_applier(m_state.model), task, feature_fn, method="meanflow",
                             n_steps=1, cfg_strength=0.0, t_scale=1.0)
    _save_grid_rgb(m_dec[:24], os.path.join(out, "image_meanflow.png"))
    print(f"[image] meanflow {m_q} ({time.time() - t0:.0f}s)", flush=True)
    payload["meanflow_loss_curve"] = _curve(m_losses)
    summary["meanflow_loss_floor"] = _floor(m_losses)
    summary["meanflow_1nfe"] = m_q
    emit()

    # ---- reflow Euler-5 (pairs of the base model) --------------------------
    pairs = _pairs(u_apply, pair_batches, 2000, (b, LAT_H, LAT_H, LAT_C), IMG_CLASSES,
                   eval_steps, device)

    def reflow_batch_fn(rng):
        src, tgt, cls = pairs[int(rng.integers(0, len(pairs)))]
        return {"source": src, "target": tgt, "class_cond": cls}

    # from the base's initial weights (the same seed), as the JAX tool
    # starts it from the base's initial parameters
    re = _image_unet(device=device)
    r_state, r_losses = _train(re, reflow_steps, lr=1e-3, batch_fn=reflow_batch_fn,
                               paired_source=True)
    base_e5, _ = img_quality(u_apply, task, feature_fn, method="euler", n_steps=5)
    base_e5_cfg0, _ = img_quality(u_apply, task, feature_fn, method="euler", n_steps=5,
                                  cfg_strength=0.0)
    r_q, r_dec = img_quality(_applier(r_state.model), task, feature_fn, method="euler",
                             n_steps=5, cfg_strength=0.0)
    _save_grid_rgb(r_dec[:24], os.path.join(out, "image_reflow_e5.png"))
    print(f"[image] reflow {r_q} ({time.time() - t0:.0f}s)", flush=True)
    summary["reflow_loss_floor"] = _floor(r_losses)
    summary["base_euler5"] = base_e5
    summary["base_euler5_cfg0"] = base_e5_cfg0
    summary["reflow_euler5"] = r_q
    emit()

    # ---- HDiT at the same budget and at its conditioning-uptake multiple ----
    hdit = _hdit(LAT_C, IMG_CLASSES, device)
    h_state, h_losses, h_snap = _train(hdit, steps * hdit_budget_x, lr=1e-3,
                                       batch_fn=batch_fn, snapshot_at=steps)
    h_q_eq, _ = img_quality(_applier(h_snap), task, feature_fn, n_steps=eval_steps)
    h_q, h_dec = img_quality(_applier(h_state.model), task, feature_fn, n_steps=eval_steps)
    _save_grid_rgb(h_dec[:24], os.path.join(out, "image_hdit.png"))
    print(f"[image] hdit {h_q} ({time.time() - t0:.0f}s)", flush=True)
    payload["hdit_loss_curve"] = _curve(h_losses)
    summary["hdit_loss_floor"] = _floor(h_losses)
    summary["hdit_rk4_50_equal_budget"] = h_q_eq
    summary["hdit_rk4_50_converged"] = h_q
    _save_curve({"unet": u_losses, "meanflow": m_losses,
                 "reflow": r_losses, "hdit": h_losses},
                os.path.join(out, "image_loss.png"),
                f"image task (64² blobs → 16×16×4 latents), {steps} steps")
    emit()


FAMILIES = {"unet_vs_hdit": run_unet_vs_hdit, "meanflow": run_meanflow,
            "reflow": run_reflow, "audio": run_audio, "pod": run_pod,
            "image": run_image}
DEFAULT_FAMILIES = ["unet_vs_hdit", "meanflow", "reflow", "audio", "image"]


def _size_args(fn) -> list:
    """A family's size arguments: its parameters before the ``*``."""
    return [p for p in inspect.signature(fn).parameters.values()
            if p.kind is p.POSITIONAL_OR_KEYWORD]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("families", nargs="*", choices=list(FAMILIES), metavar="family",
                    help=f"of {', '.join(FAMILIES)} (default: {' '.join(DEFAULT_FAMILIES)})")
    ap.add_argument("--device", default=None,
                    help="the card unless 'cpu' (no fallback to the CPU)")
    ap.add_argument("--out", default=OUT, help="the artifacts' directory")
    for name, fn in FAMILIES.items():
        for p in _size_args(fn):
            ap.add_argument(f"--{name}-{p.name}".replace("_", "-"), type=int, default=None,
                            dest=f"{name}__{p.name}", help=f"default {p.default}")
    args = ap.parse_args(argv)
    for name in args.families or DEFAULT_FAMILIES:
        fn = FAMILIES[name]
        sizes = {p.name: getattr(args, f"{name}__{p.name}") for p in _size_args(fn)}
        fn(**{k: v for k, v in sizes.items() if v is not None}, device=args.device,
           out=args.out)


if __name__ == "__main__":
    main()
