"""Checkpoints in the JAX package's npz contract, and the weight bridge.

The contract (``flocoder_tpu/training/checkpoint.py:38-113``): one ``.npz``
whose keys are ``model_state_dict/<path>``, ``ema_state_dict/<path>`` and
``optimizer_state_dict/<path>`` (``/``-joined parameter paths, flax
layouts), ``epoch`` and ``config_json`` (the run's config as JSON).

The bridge maps a module's ``state_dict`` onto that flat JAX tree and back.
Port modules carry linen's names (``models/layers.py``), so a key maps by
``.`` ↔ ``/`` under a prefix, and the value by its module type:

- ``nn.Conv2d`` weight OIHW ↔ ``kernel`` HWIO;
- ``nn.Conv1d`` weight (out, in/groups, k) ↔ ``kernel`` (k, in/groups,
  out): the audio codec's convolutions, grouped ones and its transposed
  convolutions (``models/audio_codec.py`` holds those in a ``Conv1d``'s
  layout; flax's ``ConvTranspose`` kernel is (k, in, out) too);
- ``nn.Linear`` weight (out, in) ↔ Dense ``kernel`` (in, out);
- ``nn.GroupNorm`` weight ↔ ``scale``;
- ``nn.Embedding`` weight ↔ ``embedding``;
- a spectrally normalised conv's power-iteration buffers ``u`` and
  ``sigma`` ↔ ``batch_stats/<parent>/SpectralNorm_<i>/Conv_<j>/kernel/u``
  (flax's ``SpectralNorm`` collection; ``models/discriminator.py``);
- the buffers a module names in ``batch_stats`` (inference BatchNorm's
  ``mean`` and ``var``, ``models/perceptual.py``) ↔
  ``batch_stats/<module path>/<name>``;
- everything else (biases, ``gamma``, buffers) by name, unchanged.

Keys match strictly: a missing or extra key raises. Adam's state crosses
in optax's layout for ``chain(clip_by_global_norm, adam(schedule))``:
``1/0/count``, ``1/0/mu/<param path>``, ``1/0/nu/<param path>`` and the
schedule's ``1/1/count`` (``adam_to_jax_flat`` / ``load_adam_jax_flat``). A
trained codec is
saved as the JAX trainer saves ``state.params`` (``to_jax_flat(codec,
VQVAE_PREFIXES)``, prefix ``vqgan_``; the SD VAE with ``SDVAE_PREFIXES``;
the DAC audio codec with ``DAC_PREFIXES``, prefix ``dac_``);
an inpainting flow run saves its mask encoder beside the U-Net
(``MASK_ENCODER_PREFIXES``, under ``mask_encoder/params``) and, for the
two optimizer groups of optax's ``multi_transform``, each group's Adam
state under ``inner_states/{model,mask}/inner_state/`` (``OPT_GROUPS``);
a discriminator's flat tree is its flax variables, ``params/…`` and
``batch_stats/…`` (``DISC_PREFIXES``, the waveform discriminators' too), and
the VGG16 features' its ``params/…`` (``VGG_PREFIXES``), ResNet50's its
``params/…`` and ``batch_stats/…`` (``RESNET_PREFIXES``).

Sharded checkpoints (``save_checkpoint_sharded`` / ``load_checkpoint_sharded``,
the JAX package's format): each rank writes ``{prefix}{epoch}.host{rank}.npz``
holding its FSDP shards as ``<leaf path>@<global shape>@<offsets>``, in the
flax layout (a torch OIHW shard is written as its HWIO slab, its offsets
permuted to match), and rank 0 the replicated leaves as ``<leaf path>@r``,
with ``epoch`` and ``config_json``. ``to_jax_flat_sharded`` and
``adam_to_jax_flat_sharded`` give a module's and its Adam state's leaves in
that form (Adam in optax's layout). Either package's loader reassembles the
other's files onto any world size.
"""
from __future__ import annotations

import glob
import json
import os
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from ..config import config_from_dict, to_dict
from ..parallel.mesh import full_tensor, shard_like

__all__ = ["checkpoint_payload", "save_checkpoint", "load_checkpoint", "to_jax_flat",
           "load_jax_flat", "adam_to_jax_flat", "load_adam_jax_flat", "UNET_PREFIXES",
           "VQVAE_PREFIXES", "SDVAE_PREFIXES", "DAC_PREFIXES", "DISC_PREFIXES",
           "VGG_PREFIXES", "RESNET_PREFIXES",
           "MASK_ENCODER_PREFIXES", "OPT_GROUPS", "subtree", "ShardPiece",
           "to_jax_flat_sharded", "adam_to_jax_flat_sharded", "save_checkpoint_sharded",
           "load_checkpoint_sharded", "FLAX_ORDER"]

_SEP = "/"

# Where each model's parameters live in the JAX trees the training scripts
# save: the flow model under {"model": {"params": ...}}, the codec under
# {"encoder": {"params": ...}, "decoder": {"params": ...}, "vq": RVQState},
# the SD VAE under the same two heads without a "vq".
UNET_PREFIXES = {"": "model/params"}
VQVAE_PREFIXES = {"encoder": "encoder/params", "decoder": "decoder/params",
                  "vq": "vq"}
SDVAE_PREFIXES = {"encoder": "encoder/params", "decoder": "decoder/params"}
# the DAC audio codec's tree has the VQVAE's heads (models/audio_codec.py)
DAC_PREFIXES = VQVAE_PREFIXES
MASK_ENCODER_PREFIXES = {"": "mask_encoder/params"}
# optax multi_transform's per-group states of the JAX flow optimizer with a
# mask encoder (training/flow.py:make_flow_optimizer)
OPT_GROUPS = {"model": "inner_states/model/inner_state/",
              "mask": "inner_states/mask/inner_state/"}
DISC_PREFIXES = {"": "params"}
VGG_PREFIXES = {"": "params"}
RESNET_PREFIXES = {"": "params"}


def _entries(module: nn.Module, prefixes: dict) -> dict:
    """{torch key: (jax key, kind)} for every parameter and buffer."""
    out = {}
    for mname, m in module.named_modules():
        items = list(m.named_parameters(recurse=False)) + \
            list(m.named_buffers(recurse=False))
        for pname, _ in items:
            tkey = f"{mname}.{pname}" if mname else pname
            sn_name = getattr(m, "sn_name", None)
            if sn_name is not None and pname in ("u", "sigma"):
                *parent, conv_name = mname.split(".")
                out[tkey] = (_SEP.join(["batch_stats", *parent, sn_name,
                                        conv_name, "kernel", pname]), "same")
                continue
            if pname in getattr(m, "batch_stats", ()):
                out[tkey] = (_SEP.join(["batch_stats", *mname.split("."), pname]), "same")
                continue
            kind, leaf = "same", pname
            if pname == "weight":
                if isinstance(m, nn.Conv2d):
                    kind, leaf = "conv", "kernel"
                elif isinstance(m, nn.Conv1d):
                    kind, leaf = "conv1d", "kernel"
                elif isinstance(m, nn.Linear):
                    kind, leaf = "dense", "kernel"
                elif isinstance(m, nn.GroupNorm):
                    leaf = "scale"
                elif isinstance(m, nn.Embedding):
                    leaf = "embedding"
            parts = (mname.split(".") if mname else []) + [leaf]
            if "" in prefixes:
                head = prefixes[""]
            else:
                head = prefixes[parts[0]]
                parts = parts[1:]
            out[tkey] = (_SEP.join([head] + parts), kind)
    return out


def _to_jax(t: torch.Tensor, kind: str) -> np.ndarray:
    """A copy in flax layout: never a view of the module's memory, which
    an optimizer updates in place. A bf16 tensor (numpy has no bf16) is
    written widened to float32, exactly; loading casts it back. An FSDP2
    shard is gathered whole first (a collective: every rank calls)."""
    t = full_tensor(t).detach().cpu()
    a = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if kind == "conv":
        return np.ascontiguousarray(a.transpose(2, 3, 1, 0))
    if kind == "conv1d":
        return np.ascontiguousarray(a.transpose(2, 1, 0))
    if kind == "dense":
        return np.ascontiguousarray(a.T)
    return a.copy()


def _from_jax(a: np.ndarray, kind: str) -> np.ndarray:
    if kind == "conv":
        return a.transpose(3, 2, 0, 1)
    if kind == "conv1d":
        return a.transpose(2, 1, 0)
    if kind == "dense":
        return a.T
    return a


def to_jax_flat(module: nn.Module, prefixes: dict) -> dict:
    """The module's state as a flat ``{jax path: numpy array}`` dict in
    flax layouts."""
    sd = module.state_dict()
    return {jkey: _to_jax(sd[tkey], kind)
            for tkey, (jkey, kind) in _entries(module, prefixes).items()}


def _tensor(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """``a`` cast to ``dtype``, as the JAX ``load_into_tree`` casts each array
    to its template's dtype (an fp32 value into a bf16 parameter rounds to
    nearest even). A bfloat16 array of the JAX package (ml_dtypes, or the
    two-byte void that ``np.save`` writes for it) is read by its bits."""
    if a.dtype.itemsize == 2 and (a.dtype.kind == "V" or a.dtype.name == "bfloat16"):
        bits = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return bits.view(torch.bfloat16).to(dtype)
    return torch.tensor(a, dtype=dtype)


def load_jax_flat(module: nn.Module, flat: dict, prefixes: dict) -> nn.Module:
    """Load a flat JAX tree into ``module`` in place, each array cast to its
    parameter's dtype. Strict: a key missing on either side, or a shape that
    disagrees, raises."""
    entries = _entries(module, prefixes)
    wanted = {jkey for jkey, _ in entries.values()}
    missing = sorted(wanted - set(flat))
    extra = sorted(set(flat) - wanted)
    if missing or extra:
        raise KeyError(f"checkpoint mismatch: missing={missing[:5]} "
                       f"extra={extra[:5]}")
    sd = module.state_dict()
    new = {}
    for tkey, (jkey, kind) in entries.items():
        a = _from_jax(np.asarray(flat[jkey]), kind)
        if tuple(a.shape) != tuple(sd[tkey].shape):
            raise ValueError(f"shape mismatch for {jkey}: {a.shape} vs "
                             f"{tuple(sd[tkey].shape)}")
        new[tkey] = _tensor(a, sd[tkey].dtype)
    module.load_state_dict(new, strict=True)
    return module


def subtree(flat: dict, prefix: str, strip: bool = False) -> dict:
    """The entries of a flat tree whose keys start with ``prefix``, with the
    prefix removed when ``strip``."""
    return {(k[len(prefix):] if strip else k): v for k, v in flat.items()
            if k.startswith(prefix)}


def adam_to_jax_flat(module: nn.Module, adam: torch.optim.Adam, step: int,
                     prefixes: dict) -> dict:
    """``adam``'s moments of ``module``'s parameters as optax's flat state
    of Adam on a schedule (a parameter without state has zero moments)."""
    entries = _entries(module, prefixes)
    out = {"1/0/count": np.asarray(step, np.int32),
           "1/1/count": np.asarray(step, np.int32)}
    for name, p in module.named_parameters():
        jkey, kind = entries[name]
        state = adam.state.get(p, {})
        for slot, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            out[f"1/0/{slot}/{jkey}"] = _to_jax(state.get(key, torch.zeros_like(p)), kind)
    return out


def load_adam_jax_flat(module: nn.Module, adam: torch.optim.Adam, flat: dict,
                       prefixes: dict) -> int:
    """Load optax's flat Adam state into ``adam`` for ``module``'s
    parameters; returns the step count. Strict: a missing moment raises."""
    entries = _entries(module, prefixes)
    count = int(flat["1/0/count"])
    for name, p in module.named_parameters():
        jkey, kind = entries[name]
        moments = {}
        for slot, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            a = _from_jax(np.asarray(flat[f"1/0/{slot}/{jkey}"]), kind)
            if tuple(a.shape) != tuple(p.shape):
                raise ValueError(f"shape mismatch for {slot}/{jkey}: {a.shape}")
            moments[key] = shard_like(p, torch.tensor(a, dtype=p.dtype))
        adam.state[p] = {"step": torch.tensor(float(count)), **moments}
    return count


def checkpoint_payload(params: dict, epoch: int, config=None,
                       ema: Optional[dict] = None, opt_state: Optional[dict] = None) -> dict:
    """The npz contract's arrays by key, as ``save_checkpoint`` writes them:
    ``model_state_dict/…`` from ``params`` (a flat JAX tree), optional
    ``ema_state_dict/…`` and ``optimizer_state_dict/…``, ``epoch`` and
    ``config_json``."""
    payload = {f"model_state_dict{_SEP}{k}": np.asarray(v)
               for k, v in params.items()}
    for head, tree in (("ema_state_dict", ema), ("optimizer_state_dict", opt_state)):
        if tree is not None:
            payload.update({f"{head}{_SEP}{k}": np.asarray(v) for k, v in tree.items()})
    payload["epoch"] = np.asarray(epoch)
    if config is not None:
        payload["config_json"] = np.asarray(json.dumps(to_dict(config)))
    return payload


def save_checkpoint(params: dict, epoch: int, ckpt_dir: str = "checkpoints",
                    prefix: str = "flow_", config=None,
                    ema: Optional[dict] = None, keep: Optional[int] = None,
                    opt_state: Optional[dict] = None) -> str:
    """Write ``{ckpt_dir}/{prefix}{epoch}.npz`` in the contract:
    ``model_state_dict/…`` from ``params`` (a flat JAX tree, e.g. from
    ``to_jax_flat``), optional ``ema_state_dict/…`` and
    ``optimizer_state_dict/…``, ``epoch`` and ``config_json``; with
    ``keep``, only the newest ``keep`` files of the prefix stay. Returns the
    path. The npz members are stored, not deflated (``np.savez``): the JAX
    writer compresses them, and either package's ``np.load`` reads both;
    float weights barely compress, and zlib took a quarter of a long run's
    host time."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"{prefix}{epoch}.npz")
    np.savez(path, **checkpoint_payload(params, epoch, config, ema, opt_state))
    if keep:
        files = sorted(glob.glob(os.path.join(ckpt_dir, f"{prefix}*.npz")),
                       key=os.path.getmtime)
        for f in files[:-keep]:
            os.remove(f)
    return path


def load_checkpoint(path: str) -> dict:
    """Returns ``{'model_state_dict': flat dict, 'ema_state_dict': …,
    'optimizer_state_dict': …, 'epoch': int, 'config': Config or None}``;
    each state dict is flat ``{jax path: numpy array}``."""
    groups: dict = {}
    epoch, config = 0, None
    with np.load(path, allow_pickle=False) as data:
        for key in data.files:
            if key == "epoch":
                epoch = int(data[key])
            elif key == "config_json":
                config = config_from_dict(json.loads(str(data[key])))
            else:
                head, _, rest = key.partition(_SEP)
                groups.setdefault(head, {})[rest] = data[key]
    return {**groups, "epoch": epoch, "config": config}


# torch dims in flax order, by kind (the transposes of ``_to_jax``)
FLAX_ORDER = {"conv": (2, 3, 1, 0), "conv1d": (2, 1, 0), "dense": (1, 0)}


class ShardPiece(NamedTuple):
    """One rank's block of a leaf, in the flax layout: its data, the leaf's
    global shape and the block's offsets."""
    data: np.ndarray
    shape: tuple
    offsets: tuple


def _piece(t: torch.Tensor, kind: str):
    """A leaf of a sharded save: a replicated tensor as its flax-layout
    array, an FSDP2 shard (a DTensor) as this rank's ``ShardPiece``."""
    if not hasattr(t, "to_local"):
        return _to_jax(t, kind)
    from torch.distributed.tensor import Shard
    mesh, shape = t.device_mesh, tuple(t.shape)
    offsets = [0] * len(shape)
    coord = mesh.get_coordinate()
    for m, pl in enumerate(t.placements):
        if isinstance(pl, Shard):
            offsets[pl.dim] += coord[m] * (shape[pl.dim] // mesh.size(m))
    order = FLAX_ORDER.get(kind, tuple(range(len(shape))))
    return ShardPiece(_to_jax(t.to_local(), kind), tuple(shape[d] for d in order),
                      tuple(offsets[d] for d in order))


def to_jax_flat_sharded(module: nn.Module, prefixes: dict) -> dict:
    """``to_jax_flat`` for a sharded save: ``{jax path: array or
    ShardPiece}``, this rank's blocks of the FSDP-sharded leaves."""
    sd = module.state_dict()
    return {jkey: _piece(sd[tkey], kind)
            for tkey, (jkey, kind) in _entries(module, prefixes).items()}


def adam_to_jax_flat_sharded(module: nn.Module, adam: torch.optim.Adam, step: int,
                             prefixes: dict) -> dict:
    """``adam_to_jax_flat`` for a sharded save: a sharded parameter's
    moments are this rank's blocks, laid out as the parameter's."""
    entries = _entries(module, prefixes)
    out = {"1/0/count": np.asarray(step, np.int32),
           "1/1/count": np.asarray(step, np.int32)}
    for name, p in module.named_parameters():
        jkey, kind = entries[name]
        state = adam.state.get(p, {})
        for slot, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            out[f"1/0/{slot}/{jkey}"] = _piece(state.get(key, torch.zeros_like(p)), kind)
    return out


def save_checkpoint_sharded(tree: dict, epoch: int, ckpt_dir: str = "checkpoints",
                            prefix: str = "flow_", config=None, keep: int = 5,
                            rank: Optional[int] = None) -> str:
    """Write this rank's ``{ckpt_dir}/{prefix}{epoch}.host{rank}.npz``:
    each ``ShardPiece`` of the flat ``tree`` as ``key@shape@offsets``, and
    on rank 0 each replicated array as ``key@r`` plus ``epoch`` and
    ``config_json`` (the JAX package's keys; members stored, not deflated).
    ``rank`` defaults to the process group's (0 outside one). Keeps this
    rank's newest ``keep`` epochs. Returns the path."""
    import torch.distributed as dist
    if rank is None:
        rank = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
    payload = {}
    for key, leaf in tree.items():
        if isinstance(leaf, ShardPiece):
            shape = ",".join(str(d) for d in leaf.shape)
            offs = "-".join(str(o) for o in leaf.offsets)
            payload[f"{key}@{shape}@{offs}"] = np.asarray(leaf.data)
        elif rank == 0:
            payload[f"{key}@r"] = np.asarray(leaf)
    if rank == 0:
        payload["epoch"] = np.asarray(epoch)
        if config is not None:
            payload["config_json"] = np.asarray(json.dumps(to_dict(config)))
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"{prefix}{epoch}.host{rank}.npz")
    np.savez(path, **payload)
    files = sorted(glob.glob(os.path.join(ckpt_dir, f"{prefix}*.host{rank}.npz")),
                   key=os.path.getmtime)
    for f in files[:-keep]:
        os.remove(f)
    return path


def load_checkpoint_sharded(ckpt_dir: str, prefix: str, epoch: int) -> dict:
    """Reassemble ``{prefix}{epoch}.host*.npz`` under ``ckpt_dir``, written
    by either package on any number of ranks: ``{'state': flat {jax path:
    full array}, 'epoch': int, 'config': Config or None}``. A block that
    two files hold is taken from the first."""
    files = sorted(glob.glob(os.path.join(ckpt_dir, f"{prefix}{epoch}.host*.npz")))
    if not files:
        raise FileNotFoundError(f"no {prefix}{epoch}.host*.npz under {ckpt_dir}")
    flat, parts, config = {}, {}, None
    for f in files:
        with np.load(f, allow_pickle=False) as data:
            for key in data.files:
                if key == "epoch":
                    epoch = int(data[key])
                elif key == "config_json":
                    config = config_from_dict(json.loads(str(data[key])))
                else:
                    leaf, _, tail = key.partition("@")
                    if tail == "r":
                        flat[leaf] = data[key]
                        continue
                    shape_s, _, offs_s = tail.partition("@")
                    entry = parts.setdefault(leaf, {
                        "shape": tuple(int(d) for d in shape_s.split(",") if d),
                        "blocks": {}})
                    entry["blocks"].setdefault(
                        tuple(int(o) for o in offs_s.split("-") if o != ""), data[key])
    for leaf, entry in parts.items():
        blocks = entry["blocks"]
        sample = next(iter(blocks.values()))
        if not entry["shape"]:
            flat[leaf] = sample
            continue
        full = np.zeros(entry["shape"], dtype=sample.dtype)
        for offs, block in blocks.items():
            full[tuple(slice(o, o + n) for o, n in zip(offs, block.shape))] = block
        flat[leaf] = full
    return {"state": flat, "epoch": epoch, "config": config}
