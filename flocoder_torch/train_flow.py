"""Train a latent flow-matching model on the CUDA card — the port of the
repo's ``train_flow.py``, on one device or on the ranks of a
``torchrun`` world.

Usage:
    python -m flocoder_torch.train_flow --config-name flowers_vqgan.yaml \\
        [data=/path/to/images] [flow.epochs=N] [key=value ...]

Reads the latents that the pre-encode pass wrote under
``<data>_encoded_<codec>/{train,val}``: a packed shard,
``{split}/data.fcshard``, where one exists (one native gather a batch,
``data/shard.py``; plain latents and inpainting triplets), else the latent
files (or, with ``flow.pre_encoded=false``, encodes image batches in the
step with the frozen codec), trains the velocity field (``flow.arch``: the
U-Net, or the Hourglass DiT with ``flow.arch=hdit``; either computes in
bf16 with ``flow.bf16=true``, parameters and optimizer in fp32; the codec
in bf16 with ``codec.bf16`` (``setup_codec``), else fp32, whatever
``flow.bf16`` says; HDiT's MoE levels' auxiliary loss weighted by
``flow.hdit_moe_aux_weight``, default 1e-2) with minibatch
OT, CFG dropout, clipped Adam on the cosine
warm-restart schedule and EMA (``training/flow.py``), and evaluates on the
JAX script's cadence: at every epoch below 20 and every 10th, unless
``flow.no_eval=true``, a validation loss and ``evaluate_model`` (sample,
decode through the codec, metrics, codebook usage, grids), and the EMA's at
even epochs above 5. Checkpoints every ``flow.ckpt_every`` (25) epochs as
the JAX script writes them: ``flow_<epoch>.npz`` (params, optax-layout Adam
state, EMA) and ``flowema_<epoch>.npz``, so that both packages'
``generate_samples`` load them; ``load_checkpoint=<flow_*.npz>`` resumes.
``+device=cpu`` runs on the CPU; without it the run needs a CUDA device.
``+ckpt_dir`` and ``+output_dir`` move the checkpoints (default
``checkpoints``) and the grids (``output_<data name>-<H>x<W>``). Unlike the
JAX script, a validation split smaller than the batch is read as one batch
of its size.

Inpainting: latents pre-encoded with ``inpainting=true`` (``.npz``
triplets) train the U-Net with mask conditioning and a ``MaskEncoder``
whose output is resized to the latent size; ``flow.otf_aug=true`` adds the
curriculum (``flow.curriculum_epochs``, ``extend_epochs``, ``p_ones``,
``p_zeros``) with ``blank_latents``, the codec's encode of a blank image.
The evaluation conditions on the validation batch's masks and starts from
its mask-blended sources. The checkpoints hold the mask encoder beside the
U-Net and the two optimizer groups in optax's ``multi_transform`` layout.
The JAX-only dispatch knobs ``flow.steps_per_dispatch`` and ``rng_impl``
are accepted and change nothing here (ROADMAP.md). Refused: MoE expert
and pipeline parallelism (ROADMAP.md item 13c) and orbax checkpoints.

Several ranks (``torchrun --nproc_per_node=N -m flocoder_torch.train_flow
...``; ``parallel/mesh.py``): each rank drives one device (``cuda:LOCAL_RANK``,
or ``+device``; NCCL on CUDA, gloo on the CPU or with more ranks than cards) and
loads its own slice of every epoch's shuffle (``Loader``'s ``host_shard``),
``flow.batch_size`` being the global batch (a multiple of the rank count
times ``flow.grad_accum``, as the batch-size schedule's sizes are). The
step is data-parallel (per-rank noise and OT, a global CFG gate, gradients
averaged over the ranks: ``training/flow.py``) or, with ``flow.fsdp=true``,
the FSDP step, the one-device function on the global batch with the
model, its Adam moments and its EMA in FSDP2 shards (the JAX rule:
tensors of at least 2¹⁴ elements split over the ranks). Evaluations sample
and decode sharded over the ranks. ``flow.sharded_checkpoints=true`` makes
every rank write its own ``flow_<epoch>.host<rank>.npz`` (the JAX package's
sharded format, ``training/checkpoint.py``; no ``flowema_`` file, as in the
JAX script) instead of the two ordinary files. Rank 0 alone prints, logs
and writes the grids and the ordinary checkpoints.

The model axis (``flow.n_model`` > 1; the world is ``flow.n_model`` times
the batch ranks): the mesh gains a 'model' axis, and its model ranks hold
replicas, fed the same rows and draws. With ``flow.ring_attention=true``
the step trains the ring twin (``models/flow_model.py:ring_twin``, the same
parameters): the global attention sites (the U-Net's bottleneck, HDiT's
global levels) run as the ring over the model axis
(``parallel/ring_attention.py``), whose gradients come whole to every
model rank, so the step averages over the batch ranks alone. Evaluation,
checkpoints and serving use the ring-free model, as in the JAX script. The
ring refuses, before the first step, what the JAX script cannot trace:
``flow.meanflow`` and ``flow.curvature_weight`` (the ring has no
forward-mode derivative), ``flow.fsdp`` (the JAX FSDP step leaves the
ring's axis unbound) and ``flow.pp`` (both claim the model axis).

Unless ``no_wandb`` is set, the metrics go to
``runs/<project_name>/<run_name or the start time>/metrics.jsonl``
(``utils/logging.py``, the JSONL backend; wandb is not ported) at the JAX
script's points: ``Loss/train``, ``Learning Rate``, ``epoch``,
``batch_size`` and ``samples_per_sec`` each epoch, ``Loss/val`` and the
evaluation's ``metrics/<tag>…``, ``demo/<grid>`` and ``codebook/…`` records
at each evaluation.

Reflow (``flow.reflow=true``): trains on the paired dataset that
``make_reflow_pairs`` writes (``data`` is its ``out_dir``, read as it is,
with no ``_encoded_<codec>`` suffix): each batch's ``source_latents`` is the
source of its ``target_latents``, so the step keeps the couplings (no OT
re-pairing, no CFG noise swap; ``training/flow.py``'s ``paired_source``),
and so does the validation loss. The evaluation samples from fresh noise,
as without reflow. Reflow with ``flow.meanflow``, or on data without
``source_latents`` or with masks, exits, as in the JAX script.

Audio (``codec.choice=dac``, ``audio_dac.yaml``): the flow trains on the
folded 16×16×8 latents that pre-encoding wrote (``flow.pre_encoded=false``
raises, as in the JAX script); the codec is ``codec_checkpoint`` or
``codec.checkpoint``, by default the newest ``dac_*.npz`` under
``+ckpt_dir``; the evaluation is ``evaluate_model_audio`` (waveforms,
``sinkhorn_mel``, WAVs instead of grids).
"""
from __future__ import annotations

import glob
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from .config import ldcfg, parse_cli
from .data.datasets import Loader, PreEncodedDataset, create_image_loaders
from .data.shard import ShardDataset
from .evaluation import evaluate_model, evaluate_model_audio
from .generate_samples import CONFIG_DIR
from .inpainting import MaskEncoder
from .models.audio_codec import DACCodec
from .models.codecs import VQVAE, codec_checkpoint, load_codec_weights, setup_codec
from .models.flow_model import build_flow_model, ring_twin
from .models.layers import init_params
from .parallel.mesh import (batch_rank, batch_shard_count, host_device_count, is_writer,
                            make_mesh, maybe_init_distributed, rank0_print, rank_seed)
from .models.sd_vae import SDVAE
from .models.vqgan_plus import VQGANPlus
from .training.checkpoint import (MASK_ENCODER_PREFIXES, OPT_GROUPS, UNET_PREFIXES,
                                  adam_to_jax_flat, adam_to_jax_flat_sharded,
                                  load_adam_jax_flat, load_checkpoint, load_jax_flat,
                                  save_checkpoint, save_checkpoint_sharded, subtree,
                                  to_jax_flat, to_jax_flat_sharded)
from .training.flow import (create_flow_state, make_flow_eval_step, make_flow_train_step,
                            shard_flow_state)
from .training.schedules import batch_size_schedule, cosine_warm_restarts_decay
from .utils import logging as wblog
from .utils.codebook_analysis import CodebookUsageTracker

__all__ = ["train_flow", "latent_dataset", "main"]


def _uses_ring(config) -> bool:
    """``flow.ring_attention`` on a model axis (``flow.n_model`` > 1), as
    the JAX script reads it."""
    return bool(ldcfg(config, "ring_attention", False)) and int(ldcfg(config, "n_model", 1)) > 1


def _refuse_unported(config) -> None:
    ring = _uses_ring(config)
    if ring and bool(ldcfg(config, "pp", False)):
        raise SystemExit("flow.pp and flow.ring_attention both claim the mesh 'model' "
                         "axis; pick one")
    flags = {"moe_ep": "MoE expert parallelism, ROADMAP.md item 13c",
             "pp": "pipeline parallelism, ROADMAP.md item 13c",
             "orbax_checkpoints": "orbax checkpoints, which ROADMAP.md does not queue"}
    for key, what in flags.items():
        if bool(ldcfg(config, key, False)):
            raise NotImplementedError(f"flow.{key} is not ported: {what}")
    if ring and (bool(ldcfg(config, "meanflow", False))
                 or float(ldcfg(config, "curvature_weight", 0.0))):
        raise ValueError("flow.ring_attention does not combine with flow.meanflow or "
                         "flow.curvature_weight: the ring defines no forward-mode "
                         "derivative, as the JAX script's ring, a custom_vjp that jax.jvp "
                         "cannot push forward, fails its first step's trace")
    if ring and bool(ldcfg(config, "fsdp", False)):
        raise ValueError("flow.fsdp does not combine with flow.ring_attention: the JAX "
                         "script's FSDP step is plain jit, where the ring's 'model' axis "
                         "is unbound, and fails its first step's trace")


def latent_dataset(split_dir: str, n_classes: int = 0):
    """The latents of one pre-encoded split: its packed shard
    (``data.fcshard``, read by the native gather) where one exists, else
    its latent files."""
    shard_path = os.path.join(split_dir, "data.fcshard")
    if os.path.exists(shard_path):
        ds = ShardDataset(shard_path, n_classes=n_classes)
        print(f"[{os.path.basename(split_dir)}] packed shard "
              f"({'native' if ds.reader.is_native else 'numpy'} gather), {len(ds)} records")
        return ds
    return PreEncodedDataset(split_dir, n_classes=n_classes)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _to_device(batch: dict, device) -> dict:
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.asarray(v))
        out[k] = (t.long() if k == "class_cond" else t).to(device, non_blocking=True)
    return out


def _params_flat(model, mask_encoder) -> dict:
    """The flat JAX tree of the flow params: the model and, for
    inpainting, the mask encoder."""
    flat = to_jax_flat(model, UNET_PREFIXES)
    if mask_encoder is not None:
        flat.update(to_jax_flat(mask_encoder, MASK_ENCODER_PREFIXES))
    return flat


def _load_params(model, mask_encoder, flat: dict) -> None:
    load_jax_flat(model, subtree(flat, "model/"), UNET_PREFIXES)
    if mask_encoder is not None:
        load_jax_flat(mask_encoder, subtree(flat, "mask_encoder/"), MASK_ENCODER_PREFIXES)


def _opt_flat(state, adam_flat=adam_to_jax_flat) -> dict:
    """optax's flat state of the flow optimizer: one Adam state, or with a
    mask encoder the two groups of ``multi_transform``."""
    model = adam_flat(state.model, state.opt.adam, state.step, UNET_PREFIXES)
    if state.mask_encoder is None:
        return model
    mask = adam_flat(state.mask_encoder, state.mask_opt.adam, state.step,
                     MASK_ENCODER_PREFIXES)
    return {**{OPT_GROUPS["model"] + k: v for k, v in model.items()},
            **{OPT_GROUPS["mask"] + k: v for k, v in mask.items()}}


def _load_opt(state, flat: dict) -> None:
    if state.mask_encoder is None:
        load_adam_jax_flat(state.model, state.opt.adam, flat, UNET_PREFIXES)
        return
    load_adam_jax_flat(state.model, state.opt.adam,
                       subtree(flat, OPT_GROUPS["model"], strip=True), UNET_PREFIXES)
    load_adam_jax_flat(state.mask_encoder, state.mask_opt.adam,
                       subtree(flat, OPT_GROUPS["mask"], strip=True), MASK_ENCODER_PREFIXES)


def _sharded_tree(state) -> dict:
    """The JAX script's sharded-checkpoint tree ``{params, opt_state, ema}``,
    flat, with this rank's blocks of the FSDP-sharded leaves."""
    def flat(model, mask_encoder):
        out = to_jax_flat_sharded(model, UNET_PREFIXES)
        if mask_encoder is not None:
            out.update(to_jax_flat_sharded(mask_encoder, MASK_ENCODER_PREFIXES))
        return out
    tree = {f"params/{k}": v for k, v in flat(state.model, state.mask_encoder).items()}
    tree.update({f"opt_state/{k}": v
                 for k, v in _opt_flat(state, adam_to_jax_flat_sharded).items()})
    tree.update({f"ema/{k}": v for k, v in flat(state.ema, state.ema_mask_encoder).items()})
    return tree


def _keep_recent_files(keep: int, directory: str, pattern: str) -> None:
    files = sorted(glob.glob(os.path.join(directory, pattern)), key=os.path.getmtime)
    for f in files[:-keep]:
        os.remove(f)


def train_flow(config, step_hook: Optional[Callable[[int], None]] = None) -> dict:
    """Returns ``{'state': FlowState, 'epoch_seconds': [{'epoch', 'steps',
    'samples', 'seconds'}], 'epochs': [per-epoch mean losses], 'eval':
    [{'epoch', 'tag', 'metrics', 'seconds'}], 'ot_rounds': [per step],
    'checkpoint': path, 'ema_checkpoint': path, 'output_dir': str,
    'metrics_log': path or None, 'device': str, 'ranks': int, 'fsdp': bool,
    'sharded': {parameter name: the dim FSDP splits, or None} or None,
    'model_axis': int, 'ring': bool}``
    (under ``flow.sharded_checkpoints`` ``checkpoint`` is this rank's file
    and ``ema_checkpoint`` None). The device is
    synchronised once an epoch, as in the JAX script: an epoch's seconds
    cover its training loop (the loader's wait, the copy to the device and
    the steps) and end in that synchronise. ``step_hook``, if given, is
    called with the epoch after each step is queued, e.g. to record a CUDA
    event. An evaluation's ``seconds`` are split into 'sampler', 'decode',
    'metrics' and 'grids'."""
    _refuse_unported(config)
    device = maybe_init_distributed(config.get("device", None))
    n_model = int(ldcfg(config, "n_model", 1))
    mesh = make_mesh(n_model=n_model, device=device)
    use_ring = _uses_ring(config)
    n_shards = batch_shard_count(mesh)
    writer = is_writer()
    fsdp = bool(ldcfg(config, "fsdp", False))
    sharded_ckpt = bool(ldcfg(config, "sharded_checkpoints", False))
    if mesh is not None:
        rank0_print(f"train_flow: mesh {mesh}, {host_device_count()} rank(s) on this host, "
                    f"{'FSDP' if fsdp else 'data-parallel'} step"
                    + (f", ring attention over 'model' (size {n_model})" if use_ring else ""))
    data_path = os.path.expanduser(str(config.data))
    # reflow pairs are latents already (make_reflow_pairs): no codec suffix
    reflow = bool(ldcfg(config, "reflow", False))
    meanflow = bool(ldcfg(config, "meanflow", False))
    if meanflow and reflow:
        raise SystemExit("flow.meanflow=true does not combine with "
                         "inpainting datasets or flow.reflow")
    if "encoded" not in data_path and not reflow:
        data_path = f"{data_path}_encoded_{config.codec.choice}"
    batch_size = int(ldcfg(config, "batch_size", 256))
    grad_accum = max(int(ldcfg(config, "grad_accum", 1)), 1)
    bs_step_every = int(ldcfg(config, "bs_step_every", 0))
    bs_milestones = [int(m) for m in (ldcfg(config, "bs_milestones", None) or [])]
    bs_sched = None
    if bs_step_every or bs_milestones:
        bs_sched = batch_size_schedule(
            batch_size, gamma=float(ldcfg(config, "bs_gamma", 2.0)),
            step_every=bs_step_every, milestones=bs_milestones,
            max_bs=int(ldcfg(config, "bs_max", 0)) or None,
            multiple_of=n_shards * grad_accum)
    if batch_size % n_shards:
        raise ValueError(f"flow.batch_size={batch_size} does not split over "
                         f"{n_shards} ranks")
    n_classes = int(ldcfg(config, "n_classes", 0))
    epochs = int(ldcfg(config, "epochs", 100))
    n_steps_eval = int(ldcfg(config, "n_steps", 100))
    cfg_strength = float(ldcfg(config, "cfg_strength", 3.0))
    is_midi = any(s in data_path.lower() for s in ("pop909", "midi"))
    keep_gray = int(ldcfg(config, "in_channels", 3)) == 1
    seed = int(ldcfg(config, "seed", 0))
    pre_encoded = bool(ldcfg(config, "pre_encoded", True))
    image_size = int(ldcfg(config, "image_size", 128))
    num_workers = int(ldcfg(config, "num_workers", 4))
    t_scale = 1.0 if meanflow else 999.0
    gen = torch.Generator(device)
    host_shard = (batch_rank(mesh), n_shards) if n_shards > 1 else None

    # ---- the frozen codec: the evaluation's decode, the on-the-fly encode
    codec = setup_codec(config, device=device)
    is_audio = isinstance(codec, DACCodec)
    if is_audio and not pre_encoded:
        raise SystemExit("codec.choice=dac trains flows on pre-encoded latents "
                         "(run preencode_data first)")
    if isinstance(codec, (VQVAE, VQGANPlus, SDVAE, DACCodec)):
        codec.init(gen.manual_seed(seed))
        load_codec_weights(codec, codec_checkpoint(
            config, ldcfg(config, "codec_checkpoint", None)))
    codec.eval().requires_grad_(False)
    encode_fn = None

    # ---- data
    if pre_encoded:
        train_ds = latent_dataset(f"{data_path}/train", n_classes)
        val_ds = latent_dataset(f"{data_path}/val", n_classes)
        train_loader = Loader(train_ds, batch_size // n_shards, num_workers, seed,
                              host_shard=host_shard)
        val_loader = Loader(val_ds, min(batch_size, len(val_ds)), num_workers, seed + 1)
        batch0 = next(iter(train_loader))
        H, W, C = batch0["target"].shape[1:]
    else:
        train_loader, val_loader = create_image_loaders(
            batch_size, image_size, os.path.expanduser(str(config.data)),
            num_workers=num_workers, is_midi=is_midi, seed=seed)
        train_loader.key = val_loader.key = "pixels"
        train_loader.host_shard = host_shard
        train_loader.batch_size = batch_size // n_shards
        batch0 = {}
        H, W, C = codec.latent_shape(image_size)
        encode_fn = codec.encode
        print(f"on-the-fly mode: encoding {image_size}px images in the step")
    inpainting = "mask_pixels" in batch0
    # reflow keeps the pairs' couplings: it needs sources and no masks
    if reflow and ("source" not in batch0 or inpainting):
        raise SystemExit("flow.reflow=true needs a paired dataset with "
                         "source_latents and no masks — generate one with "
                         "python -m flocoder_torch.make_reflow_pairs")
    if meanflow and inpainting:
        raise SystemExit("flow.meanflow=true does not combine with inpainting "
                         "datasets or flow.reflow")
    rank0_print(f"latent shape HWC = {(H, W, C)}, inpainting = {inpainting}, "
                f"reflow = {reflow}, n_batches/epoch = {len(train_loader)}")
    output_dir = str(config.get("output_dir",
                                f"output_{os.path.basename(data_path)}-{H}x{W}"))
    ckpt_dir = str(config.get("ckpt_dir", "checkpoints"))
    if writer:
        os.makedirs(output_dir, exist_ok=True)

    # ---- model, optimizer, state
    dtype = torch.bfloat16 if bool(ldcfg(config, "bf16", False)) else torch.float32
    model = build_flow_model(config, C, n_classes, dual_time=meanflow, dtype=dtype,
                             dim=H, mask_cond=inpainting).to(device)
    init_params(model, gen.manual_seed(seed + 1))
    mask_encoder = None
    if inpainting:
        mask_encoder = MaskEncoder(output_channels=C, target_hw=(H, W)).to(device)
        init_params(mask_encoder, gen.manual_seed(seed + 3))
    model_apply = None
    if any(lv.moe_experts for lv in getattr(model, "levels", ())):
        if meanflow:
            raise SystemExit("flow.hdit_moe_experts does not combine with "
                             "flow.meanflow (the MeanFlow identity jvp has no "
                             "aux-loss channel)")
        moe_aux_w = float(ldcfg(config, "hdit_moe_aux_weight", 1e-2))

        def model_apply(m, x, t, c):
            # the MoE blocks' mean auxiliary loss joins the objective
            v, aux = m(x, t, c, return_aux=True)
            return v, moe_aux_w * aux["moe_aux"].mean()
    if use_ring:
        # the training twin: the same parameters, the ring at the global
        # attention sites; evaluation and checkpoints read the model itself
        train_model = ring_twin(model, n_model)
        inner = model_apply or (lambda m, x, t, c: m(x, t, c))
        model_apply = lambda m, x, t, c: inner(train_model, x, t, c)  # noqa: E731
    n_params = sum(p.numel() for m in (model, mask_encoder) if m is not None
                   for p in m.parameters())
    rank0_print(f"model params: {n_params / 1e6:.2f}M  device {device}")
    sched = cosine_warm_restarts_decay(
        float(ldcfg(config, "learning_rate", 1e-4)), T_0=int(ldcfg(config, "lr_T0", 50)),
        T_mult=int(ldcfg(config, "lr_Tmult", 2)), decay=float(ldcfg(config, "lr_decay", 0.6)),
        steps_per_epoch=max(len(train_loader), 1))
    state = create_flow_state(model, sched, mask_encoder=mask_encoder)
    start_epoch = 1
    resume = ldcfg(config, "load_checkpoint", None)
    ck = load_checkpoint(str(resume)) if resume and os.path.exists(str(resume)) else None
    if ck is not None:
        _load_params(state.model, state.mask_encoder, ck["model_state_dict"])
        _load_params(state.ema, state.ema_mask_encoder,
                     ck.get("ema_state_dict") or ck["model_state_dict"])
    sharded = shard_flow_state(state, mesh) if fsdp else None
    if ck is not None:
        if ck.get("optimizer_state_dict"):
            _load_opt(state, ck["optimizer_state_dict"])
        state.step = ck["epoch"] * len(train_loader)
        start_epoch = ck["epoch"] + 1
        rank0_print(f"resumed from {resume} at epoch {ck['epoch']}")
    if sharded is not None:
        rank0_print(f"FSDP: {sum(d is not None for d in sharded.values())} of {len(sharded)} "
                    f"parameters sharded over {n_shards} rank(s)")

    # the inpainting curriculum: (p_ones, p_zeros) by epoch from the step
    # counter; "ones" start from blank_latents, the codec's blank image
    blank_latents, otf_aug = None, None
    if inpainting and bool(ldcfg(config, "otf_aug", False)):
        with torch.no_grad():
            blank_latents = codec.encode(torch.zeros(1, image_size, image_size,
                                                     codec.in_channels, device=device))
        rank0_print(f"blank_latents range [{float(blank_latents.min()):.3f}, "
                    f"{float(blank_latents.max()):.3f}]")
        otf_aug = {"curriculum_epochs": int(ldcfg(config, "curriculum_epochs", 0)),
                   "extend_epochs": int(ldcfg(config, "extend_epochs", 0)),
                   "p_ones": float(ldcfg(config, "p_ones", 0.0)),
                   "p_zeros": float(ldcfg(config, "p_zeros", 0.0)),
                   "steps_per_epoch": max(len(train_loader), 1)}
    # flow.steps_per_dispatch batches the JAX package's host dispatches;
    # here every step is its own call, so the option changes nothing
    step_kwargs = dict(
        blank_latents=blank_latents, otf_aug=otf_aug,
        ema_decay=float(ldcfg(config, "ema_decay", 0.999)), encode_fn=encode_fn,
        ot_method=str(ldcfg(config, "ot_method", "parallel")),
        ot_block=int(ldcfg(config, "ot_block", 0)) or None,
        curvature_weight=float(ldcfg(config, "curvature_weight", 0.0)),
        meanflow=meanflow, meanflow_ratio=float(ldcfg(config, "meanflow_ratio", 0.25)),
        meanflow_adaptive_p=float(ldcfg(config, "meanflow_adaptive_p", 0.5)),
        t_scale=t_scale, grad_accum=grad_accum, model_apply=model_apply,
        paired_source=reflow, mesh=mesh, fsdp=fsdp)
    train_step = make_flow_train_step(**step_kwargs)
    eval_step = make_flow_eval_step(t_scale=t_scale, paired_source=reflow)
    use_wandb = writer and not bool(ldcfg(config, "no_wandb", False))
    log_path = None
    if use_wandb:
        log_path = wblog.init(project=str(ldcfg(config, "project_name", "flocoder-flow")),
                              name=ldcfg(config, "run_name", None), config=dict(config))
    cb_tracker = CodebookUsageTracker(
        num_levels=int(ldcfg(config, "codebook_levels", 4)),
        codebook_size=int(ldcfg(config, "vq_num_embeddings", 32)))
    codec_quantize = codec.quantize if isinstance(codec, (VQVAE, VQGANPlus)) else None
    eval_method = str(ldcfg(config, "eval_method", "meanflow" if meanflow else "rk4"))

    epoch_seconds, history, evals, ot_rounds = [], [], [], []
    ck_path = ema_path = None
    gen.manual_seed(seed + 2)
    # each rank's own stream: the data-parallel step's draws and the sharded
    # evaluation's noise (the FSDP step draws the global batch's from gen)
    rank_gen = gen if n_shards == 1 else torch.Generator(device).manual_seed(
        rank_seed(seed + 2, mesh))
    step_gen = gen if fsdp else rank_gen
    t_start = time.time()
    for epoch in range(start_epoch, epochs + 1):
        if bs_sched is not None and bs_sched(epoch) != train_loader.batch_size * n_shards:
            rank0_print(f"  batch size {train_loader.batch_size * n_shards} -> "
                        f"{bs_sched(epoch)} (bs schedule)")
            train_loader.batch_size = bs_sched(epoch) // n_shards
        ep_aux, t_ep = [], time.time()
        for batch in train_loader:
            if not (inpainting or reflow):
                batch.pop("source", None)
            batch = _to_device(batch, device)
            state, aux = train_step(state, batch, step_gen)
            if step_hook is not None:
                step_hook(epoch)
            ep_aux.append(aux)
        _sync(device)                   # one device sync per epoch, not per step
        seconds = time.time() - t_ep
        samples = len(ep_aux) * train_loader.batch_size * n_shards
        epoch_seconds.append({"epoch": epoch, "steps": len(ep_aux), "samples": samples,
                              "seconds": seconds})
        ot_rounds += [int(a["ot_rounds"]) for a in ep_aux if "ot_rounds" in a]
        means = {k: float(torch.stack([a[k].float() for a in ep_aux]).mean())
                 for k in ep_aux[0]} if ep_aux else {"loss": float("nan")}
        history.append({"epoch": epoch, **means})
        lr_now = float(sched(state.step))
        rank0_print(f"epoch {epoch}/{epochs}  loss {means['loss']:.4f}  "
                    f"lr {lr_now:.2e}  {len(ep_aux) / max(seconds, 1e-9):.2f} it/s  "
                    f"({samples / max(seconds, 1e-9):.0f} samples/s)", flush=True)
        if use_wandb:
            wblog.log({"Loss/train": means["loss"], "Learning Rate": lr_now, "epoch": epoch,
                       "batch_size": train_loader.batch_size * n_shards,
                       "samples_per_sec": samples / max(seconds, 1e-9)})

        if not bool(ldcfg(config, "no_eval", False)) and (epoch < 20 or epoch % 10 == 0):
            vb = next(iter(val_loader))
            if not (inpainting or reflow):
                vb.pop("source", None)
            vb = _to_device(vb, device)
            if encode_fn is not None:
                with torch.no_grad():
                    vb["target"] = encode_fn(vb.pop("pixels"))
            val_loss = float(eval_step(state.model, vb, gen, mask_encoder=state.mask_encoder))
            rank0_print(f"  val loss {val_loss:.4f}")
            if use_wandb:
                wblog.log({"Loss/val": val_loss, "epoch": epoch})
            # inpainting conditions on the val batch's own masks, from its
            # mask-blended sources
            eval_mask_cond = eval_source = None
            if inpainting:
                with torch.no_grad():
                    eval_mask_cond = state.mask_encoder(vb["mask_pixels"])
                    noise = torch.randn(vb["source"].shape, generator=gen, device=device)
                    eval_source = vb["source"] + eval_mask_cond * (noise - vb["source"])
            runs = [("", state.model)]
            if epoch > 5 and epoch % 2 == 0:
                runs.append(("ema_", state.ema))
            eval_fn = evaluate_model_audio if is_audio else evaluate_model
            for tag, net in runs:
                marks, t_mark = {}, [time.time()]

                def mark(name, marks=marks, t_mark=t_mark):
                    _sync(device)
                    marks[name] = time.time() - t_mark[0]
                    t_mark[0] = time.time()

                metrics = eval_fn(
                    net, codec, epoch, vb["target"], rank_gen,
                    cond={"class_cond": vb["class_cond"], "mask_cond": eval_mask_cond},
                    batch_size=min(batch_size, 256), n_classes=n_classes,
                    method=eval_method, n_steps=n_steps_eval, cfg_strength=cfg_strength,
                    is_midi=is_midi, keep_gray=keep_gray, tag=tag, cb_tracker=cb_tracker,
                    codec_quantize=codec_quantize, use_wandb=use_wandb,
                    output_dir=output_dir,
                    source=eval_source,
                    mask_pixels=vb["mask_pixels"] if inpainting else None,
                    t_scale=t_scale, mark=mark, mesh=mesh)
                evals.append({"epoch": epoch, "tag": tag, "val_loss": val_loss,
                              "metrics": metrics, "seconds": marks})
                rank0_print(f"  {tag}metrics: " +
                            (f"sinkhorn_mel {metrics['sinkhorn_mel']:.4f}  " if is_audio else
                             f"FID_px {metrics['FID_px']:.2f}  ") +
                            f"sinkhorn {metrics['sinkhorn']:.4f}  ({sum(marks.values()):.2f} s)")
            if epoch % 2 == 0:
                cb_tracker.reset_all()

        if epoch % int(ldcfg(config, "ckpt_every", 25)) == 0:
            if sharded_ckpt:        # every rank writes its own blocks
                ck_path = save_checkpoint_sharded(_sharded_tree(state), epoch,
                                                  ckpt_dir=ckpt_dir, prefix="flow_",
                                                  config=config, keep=5)
            else:                   # gathered whole on every rank (FSDP), rank 0 writes
                ema_flat = _params_flat(state.ema, state.ema_mask_encoder)
                flats = (_params_flat(state.model, state.mask_encoder), _opt_flat(state))
                if writer:
                    ck_path = save_checkpoint(flats[0], epoch, ckpt_dir=ckpt_dir,
                                              prefix="flow_", config=config, keep=5,
                                              ema=ema_flat, opt_state=flats[1])
                    ema_path = save_checkpoint(ema_flat, epoch, ckpt_dir=ckpt_dir,
                                               prefix="flowema_", config=config, keep=5)
            if writer:
                _keep_recent_files(100, output_dir, "*.png")
                print(f"  checkpoints -> {ck_path}, {ema_path}")
    rank0_print(f"done in {time.time() - t_start:.0f}s")
    if use_wandb:
        wblog.finish()
    return {"state": state, "epoch_seconds": epoch_seconds,
            "epochs": history, "eval": evals, "ot_rounds": ot_rounds,
            "checkpoint": ck_path, "ema_checkpoint": ema_path, "output_dir": output_dir,
            "metrics_log": log_path, "device": str(device), "ranks": n_shards,
            "fsdp": sharded is not None, "sharded": sharded, "model_axis": n_model,
            "ring": use_ring}


def main(argv=None, step_hook: Optional[Callable[[int], None]] = None) -> dict:
    config = parse_cli(argv, default_config=None, config_dir=CONFIG_DIR)
    return train_flow(config, step_hook)


if __name__ == "__main__":
    main()
