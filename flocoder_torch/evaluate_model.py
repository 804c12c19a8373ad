"""Evaluate a trained flow checkpoint on the CUDA card — the port of the
repo's ``evaluate_model.py``: sample, decode, and compute the metric bundle
(FID on rp2048 features, Sinkhorn, MSE, moments) against a batch of
pre-encoded validation latents.

Usage:
    python -m flocoder_torch.evaluate_model --config-name flowers_vqgan.yaml \\
        +flow_checkpoint=checkpoints/flowema_40.npz [+n_samples=256]

Without ``+flow_checkpoint`` the newest ``checkpoints/flowema_*`` (else
``flow_*``) is taken. ``+device=cpu`` runs on the CPU; without it the run
needs a CUDA device. Grids go to ``+output_dir`` (``eval_out``). The
validation latents are the split's packed shard (``val/data.fcshard``)
where one exists, else its latent files. On several ranks (``torchrun``;
``parallel/mesh.py``) the sampling and decoding are sharded over them
(``evaluation.evaluate_model``), and rank 0 prints and writes.
"""
from __future__ import annotations

import os

import torch

from .config import ldcfg, parse_cli
from .data.datasets import Loader
from .evaluation import evaluate_model
from .generate_samples import CONFIG_DIR, load_models_once
from .models.codecs import latest_checkpoint
from .parallel.mesh import make_mesh, maybe_init_distributed, rank0_print, rank_seed
from .train_flow import latent_dataset

__all__ = ["main"]


def main(argv=None) -> dict:
    """Returns the metrics (floats, plus ``FID_feature_backend``)."""
    config = parse_cli(argv, default_config=None, config_dir=CONFIG_DIR)
    device = maybe_init_distributed(config.get("device", None))
    mesh = make_mesh(device=device)
    flow_ckpt = str(config.get("flow_checkpoint", "") or "")
    if not flow_ckpt:
        flow_ckpt = (latest_checkpoint("checkpoints", "flowema_") or
                     latest_checkpoint("checkpoints", "flow_") or "")
    if not os.path.exists(flow_ckpt):
        raise SystemExit(f"checkpoint not found: {flow_ckpt!r}")
    b = load_models_once(config, flow_ckpt, device)

    data_path = os.path.expanduser(str(config.data))
    if "encoded" not in data_path:
        data_path = f"{data_path}_encoded_{config.codec.choice}"
    n_samples = int(config.get("n_samples", 256))
    ds = latent_dataset(os.path.join(data_path, "val"))
    vb = next(iter(Loader(ds, batch_size=min(n_samples, len(ds)), num_workers=2, seed=0)))
    target = torch.from_numpy(vb["target"]).to(device)
    metrics = evaluate_model(
        b["model"], b["codec"], 0, target,
        torch.Generator(device).manual_seed(rank_seed(int(config.get("seed", 0)), mesh)),
        cond={"class_cond": torch.from_numpy(vb["class_cond"]).long().to(device),
              "mask_cond": None},
        batch_size=target.shape[0], n_classes=b["n_classes"],
        method=str(config.get("method", "rk4")),
        n_steps=int(config.get("n_steps", ldcfg(config, "n_steps", 100))),
        cfg_strength=float(config.get("cfg_strength", ldcfg(config, "cfg_strength", 3.0))),
        t_scale=float(b["t_scale"]), use_wandb=False,
        output_dir=str(config.get("output_dir", "eval_out")), mesh=mesh)
    for k, v in sorted(metrics.items()):
        rank0_print(f"{k:>20s}: {v:.5f}" if isinstance(v, float) else f"{k:>20s}: {v}")
    return metrics


if __name__ == "__main__":
    main()
