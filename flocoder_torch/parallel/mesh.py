"""The parallel layer's data axis, PyTorch port of
``flocoder_tpu/parallel/mesh.py``.

The JAX package runs one process over every device of a host and splits
arrays over a ``jax.sharding.Mesh``. Here one process drives one device: a
rank of a ``torch.distributed`` world is what a device is in the JAX mesh,
and ``torchrun`` (or ``torch.multiprocessing.spawn``) starts the ranks. A
process outside any world is the degenerate mesh (``make_mesh`` returns
``None``), and every caller then runs exactly as on one device.

- ``maybe_init_distributed``: joins the world that ``torchrun``'s
  ``RANK``/``WORLD_SIZE``/``LOCAL_RANK``/``MASTER_*`` describe, as the JAX
  one joins the world of ``JAX_COORDINATOR_ADDRESS``; it returns the rank's
  device, ``cuda:LOCAL_RANK`` unless the caller names one. The backend
  follows from what the rank sees: NCCL with a card of its own, gloo on the
  CPU or where the host runs more ranks than it has cards (NCCL refuses two
  ranks on one device; gloo moves CUDA tensors too).
- ``make_mesh``: a ``DeviceMesh`` over the whole world with the axes
  ``('data', 'model')``, or ``('dcn', 'data', 'model')`` with ``n_dcn > 1``.
- The batch is split over the batch axes (``batch_axis_names``) in rank
  order: ``shard_batch`` gives a rank its rows of a host batch, a batch
  whose lead dim does not divide stays whole on every rank (the JAX
  package replicates it), and ``pmean_``, ``psum_``, ``broadcast0_`` and
  ``gather_rows`` are the collectives over those axes.
- FSDP (``shard_state``): FSDP2's ``fully_shard`` with the JAX rule of
  ``fsdp_param_shardings``: a parameter of at least ``min_size`` elements
  is split over 'data' on the largest evenly divisible dim of its flax
  layout, every other one is replicated (left to the caller's
  ``pmean_``, as FSDP2's ``ignored_params``).

- The model axis (``n_model`` > 1): ranks lie row-major as the JAX mesh
  lays out devices, rank r at batch coordinate r // n_model and model
  coordinate r % n_model. The model ranks of a batch coordinate take the
  same rows and the same random stream (``shard_batch``, ``rank_seed``), so
  they hold replicas (computed with cuDNN's deterministic algorithms); ``ring_permute_`` (one hop to model rank +1, the JAX
  ``ppermute`` j → j+1) and ``model_all_gather`` (the tiled
  ``all_gather``) are the collectives of ring attention
  (``parallel/ring_attention.py``) over the model group alone. Tensor
  parallelism (``tp_param_shardings``, ``shard_state_tp``) is ROADMAP item
  13b-ii and raises.

A mesh or world that was asked for and cannot be formed raises; nothing
falls back to one rank.
"""
from __future__ import annotations

import os
import warnings
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from ..utils.device import resolve_device

__all__ = ["DATA_AXIS", "MODEL_AXIS", "DCN_AXIS", "maybe_init_distributed",
           "make_mesh", "batch_axis_names", "batch_shard_count", "batch_group",
           "batch_rank", "is_writer", "rank0_print", "host_device_count", "shard_batch", "pmean_",
           "psum_", "broadcast0_", "gather_rows", "rank_seed",
           "fsdp_param_shardings", "shard_state", "full_tensor", "shard_like",
           "sharded_sq_norm", "tp_param_shardings",
           "shard_state_tp", "model_axis_size", "model_rank", "model_group",
           "ring_permute_", "model_all_gather"]

DATA_AXIS = "data"
MODEL_AXIS = "model"
DCN_AXIS = "dcn"


# the groups of the mesh that ``make_mesh`` formed last with a model axis:
# the ring's model group and the batch group of this rank's model
# coordinate (the JAX shard_map binds the axis names for its body alike)
_MODEL_AXIS: dict = {}


def _tensor_parallel(what: str):
    raise NotImplementedError(f"{what} is the model axis's tensor parallelism, not "
                              "ported yet (ROADMAP.md item 13b-ii)")


def maybe_init_distributed(device=None) -> torch.device:
    """Join the world that ``torchrun`` describes in the environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), unless a
    process group is already up; outside one, nothing happens. Returns the
    rank's device: ``device`` when given, else ``cuda:LOCAL_RANK`` in a
    world and ``cuda`` outside one (``resolve_device``: no card and no
    ``device='cpu'`` raises). The backend is NCCL on a CUDA device, and
    gloo on the CPU or when ``LOCAL_WORLD_SIZE`` exceeds the host's cards."""
    in_world = dist.is_available() and (dist.is_initialized() or
                                        ("RANK" in os.environ and
                                         "WORLD_SIZE" in os.environ))
    if device is None and in_world:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    if in_world and not dist.is_initialized():
        gloo = dev.type != "cuda" or host_device_count() > torch.cuda.device_count()
        dist.init_process_group("gloo" if gloo else "nccl",
                                init_method="env://",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
    return dev


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, n_dcn: int = 1,
              device=None):
    """A ``DeviceMesh`` over the world, ranks laid out row-major: axes
    ``('data', 'model')``, or ``('dcn', 'data', 'model')`` when
    ``n_dcn > 1``; ``n_data`` defaults to the world size over ``n_dcn`` and
    ``n_model``. Outside a world, ``None`` (the degenerate mesh) unless more
    than one device was asked for, which raises. ``device`` gives the mesh's
    device type (default: CUDA under NCCL, else the CPU). With ``n_model``
    > 1 rank r sits at batch coordinate r // n_model and model coordinate
    r % n_model (the JAX mesh's device layout), and the mesh's groups serve
    ``batch_group`` and ``model_group``. The model ranks of a batch
    coordinate are replicas that must compute alike bit for bit, as XLA's
    do, so a model axis selects cuDNN's deterministic algorithms
    (``torch.backends.cudnn.deterministic``): its default weight-gradient
    convolutions part two ranks' U-Net steps in the last bits."""
    if not (dist.is_available() and dist.is_initialized()):
        if (n_data or 1) * n_dcn * n_model > 1:
            raise RuntimeError(f"a mesh of {(n_data or 1) * n_dcn * n_model} ranks was "
                               "asked for outside a torch.distributed world (launch with "
                               "torchrun)")
        return None
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // (n_dcn * n_model)
    if n_dcn * n_data * n_model != world:
        raise ValueError(f"a mesh of {n_dcn}×{n_data}×{n_model} ranks does not cover "
                         f"the world of {world}")
    if device is None:
        device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dtype = torch.device(device).type
    if n_dcn > 1:
        mesh = init_device_mesh(dtype, (n_dcn, n_data, n_model),
                                mesh_dim_names=(DCN_AXIS, DATA_AXIS, MODEL_AXIS))
    else:
        mesh = init_device_mesh(dtype, (n_data, n_model),
                                mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    if n_model > 1:
        # the batch group: the ranks of this model coordinate over the batch
        # axes (every rank forms every group, in the same order)
        batch, _ = dist.new_subgroups_by_enumeration(
            [list(range(m, world, n_model)) for m in range(n_model)])
        _MODEL_AXIS.clear()
        _MODEL_AXIS.update(mesh=mesh, batch=batch, model=mesh.get_group(MODEL_AXIS))
        torch.backends.cudnn.deterministic = True
    return mesh


def batch_axis_names(mesh):
    """The axes the batch is split over: ``('dcn', 'data')`` on a mesh with
    a DCN axis, ``'data'`` otherwise."""
    if DCN_AXIS in (mesh.mesh_dim_names or ()):
        return (DCN_AXIS, DATA_AXIS)
    return DATA_AXIS


def batch_shard_count(mesh) -> int:
    """How many ways the batch splits: 1 for ``None`` or one rank."""
    if mesh is None or mesh.size() == 1:
        return 1
    names = batch_axis_names(mesh)
    n = 1
    for a in (names if isinstance(names, tuple) else (names,)):
        n *= mesh.size(mesh.mesh_dim_names.index(a))
    return n


def model_axis_size(mesh) -> int:
    """The size of the mesh's 'model' axis: 1 for ``None``."""
    return 1 if mesh is None else mesh.size(mesh.mesh_dim_names.index(MODEL_AXIS))


def _groups_of(mesh) -> dict:
    if _MODEL_AXIS.get("mesh") is not mesh:
        raise RuntimeError("this mesh's model axis is not the one make_mesh formed last")
    return _MODEL_AXIS


def batch_group(mesh):
    """The process group of the batch axes: the whole world with a model
    axis of size 1, else the ranks of this rank's model coordinate."""
    if batch_shard_count(mesh) == 1:
        return None
    return dist.group.WORLD if model_axis_size(mesh) == 1 else _groups_of(mesh)["batch"]


def batch_rank(mesh) -> int:
    """This rank's linear index over the batch axes (the JAX package's
    folded ``axis_index``): row-major over ``('dcn', 'data')``, the same on
    the model ranks of a batch coordinate."""
    if batch_shard_count(mesh) == 1:
        return 0
    return dist.get_rank() // model_axis_size(mesh)


def model_group(mesh=None):
    """The process group of the 'model' axis that holds this rank: of
    ``mesh``, or of the mesh ``make_mesh`` formed last with a model axis
    (the ring's default). ``None`` on a model axis of size 1; raises where
    no model axis was formed."""
    if mesh is not None:
        return None if model_axis_size(mesh) == 1 else _groups_of(mesh)["model"]
    if not _MODEL_AXIS or not dist.is_initialized():
        raise RuntimeError("no mesh with a model axis (make_mesh(n_model > 1) in a "
                           "torch.distributed world)")
    return _MODEL_AXIS["model"]


def model_rank(group) -> int:
    """This rank's index on the model axis of ``group`` (``model_group``)."""
    return 0 if group is None else dist.get_rank(group)


def is_writer() -> bool:
    """Whether this process writes files and logs: rank 0 of the world, or
    any process outside one."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def rank0_print(*args, **kwargs) -> None:
    """``print`` on the writing rank (``is_writer``); nothing elsewhere."""
    if is_writer():
        print(*args, **kwargs)


def host_device_count() -> int:
    """The ranks this host runs (torchrun's ``LOCAL_WORLD_SIZE``; 1 outside
    a world): each drives one device."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", 1))


def rank_seed(seed: int, mesh) -> int:
    """The seed of this rank's own random stream: ``seed`` itself on one
    rank, else a 63-bit mix of ``(seed, batch rank)`` (numpy's
    ``SeedSequence``), the counterpart of the JAX ``fold_in`` of the shard
    index. A torch generator seeded with it draws a Philox stream of its
    own on each rank."""
    if batch_shard_count(mesh) == 1:
        return seed
    import numpy as np
    word = np.random.SeedSequence([seed, batch_rank(mesh)]).generate_state(1, np.uint64)[0]
    return int(word) >> 1


def shard_batch(mesh, batch, axis: int = 0):
    """This rank's rows of a host batch (a tensor, array, dict or list of
    them) on dim ``axis``, contiguous and in rank order; a leaf whose dim
    ``axis`` does not divide by the shard count stays whole, as the JAX
    package replicates it."""
    n = batch_shard_count(mesh)
    if n == 1:
        return batch
    r = batch_rank(mesh)

    def take(x):
        if x is None or x.ndim <= axis or x.shape[axis] % n:
            return x
        per = x.shape[axis] // n
        idx = (slice(None),) * axis + (slice(r * per, (r + 1) * per),)
        return x[idx]

    if isinstance(batch, dict):
        return {k: take(v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(take(v) for v in batch)
    return take(batch)


def _reduce_(tensors, group, mean: bool):
    """All-reduce ``tensors`` in place, one flat buffer per dtype (gloo has
    no AVG: a sum, then a division)."""
    tensors = [t for t in tensors if t is not None]
    if not tensors or group is None:
        return tensors
    n = dist.get_world_size(group)
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        if mean:
            flat /= n
        off = 0
        for t in ts:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()
    return tensors


def pmean_(tensors, mesh):
    """Average ``tensors`` (a list; ``None`` entries skipped) over the
    batch ranks, in place."""
    return _reduce_(list(tensors), batch_group(mesh), mean=True)


def psum_(tensors, mesh):
    """Sum ``tensors`` over the batch ranks, in place."""
    return _reduce_(list(tensors), batch_group(mesh), mean=False)


def broadcast0_(t: torch.Tensor, mesh) -> torch.Tensor:
    """Batch rank 0's value of ``t`` on every rank (the JAX ``_bcast0``),
    in place. A bool tensor crosses as uint8."""
    group = batch_group(mesh)
    if group is None:
        return t
    src = dist.get_global_rank(group, 0)
    if t.dtype == torch.bool:
        u = t.to(torch.uint8)
        dist.broadcast(u, src=src, group=group)
        t.copy_(u.bool())
    else:
        dist.broadcast(t, src=src, group=group)
    return t


def gather_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """Every batch rank's rows of ``t`` stacked on dim 0 in rank order (the
    whole batch that ``shard_batch`` split), on every rank."""
    group = batch_group(mesh)
    if group is None:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts)


def _shard_dims(t):
    """(mesh dim, tensor dim) of each ``Shard`` placement of a DTensor."""
    from torch.distributed.tensor import Shard
    return [(m, pl.dim) for m, pl in enumerate(t.placements) if isinstance(pl, Shard)]


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """An FSDP2 shard (a DTensor split evenly, as ``fsdp_param_shardings``
    splits) gathered whole with c10d's ``all_gather`` over its shard groups
    (every rank calls); a tensor as it is. DTensor's own ``full_tensor``
    goes through functional collectives, which crash gloo on CUDA tensors."""
    if not hasattr(t, "to_local"):
        return t
    local = t.to_local()
    for m, dim in _shard_dims(t):
        group = t.device_mesh.get_group(m)
        parts = [torch.empty_like(local) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, local.contiguous(), group=group)
        local = torch.cat(parts, dim=dim)
    return local


def shard_like(p: torch.Tensor, full: torch.Tensor) -> torch.Tensor:
    """``full`` (the same on every rank) split as the DTensor ``p`` is, this
    rank's block taken locally (no collective); a tensor on ``p``'s device
    when ``p`` is not a DTensor."""
    if not hasattr(p, "to_local"):
        return full.to(p.device)
    from torch.distributed.tensor import DTensor
    local = full.to(p.to_local().device)
    coord = p.device_mesh.get_coordinate()
    for m, dim in _shard_dims(p):
        local = local.chunk(p.device_mesh.size(m), dim=dim)[coord[m]]
    return DTensor.from_local(local.contiguous(), p.device_mesh, p.placements,
                              run_check=False)


def sharded_sq_norm(tensors: list) -> torch.Tensor:
    """The summed squares of FSDP2 shards over their whole tensors: each
    rank's local sums, all-reduced over the shard groups of the first."""
    part = torch.stack([torch.linalg.vector_norm(t.to_local()) ** 2 for t in tensors]).sum()
    for m, _ in _shard_dims(tensors[0]):
        dist.all_reduce(part, group=tensors[0].device_mesh.get_group(m))
    return part


def fsdp_param_shardings(module: nn.Module, n: int, min_size: int = 2 ** 14) -> dict:
    """{parameter name: torch dim it is split on over ``n`` ranks, or
    ``None`` (replicated)}, by the JAX rule: a tensor of at least
    ``min_size`` elements takes the largest dim of its flax layout that
    ``n`` divides (the first of equal ones), anything else is replicated."""
    from ..training.checkpoint import FLAX_ORDER, _entries
    kinds = {name: kind for name, (_, kind) in _entries(module, {"": ""}).items()}
    out = {}
    for name, p in module.named_parameters():
        order = FLAX_ORDER.get(kinds[name], tuple(range(p.ndim)))
        flax_shape = [p.shape[d] for d in order]
        dim = None
        if p.ndim and p.numel() >= min_size:
            for i in sorted(range(len(flax_shape)), key=lambda i: -flax_shape[i]):
                if flax_shape[i] % n == 0:
                    dim = order[i]
                    break
        out[name] = dim
    return out


def shard_state(mesh, module: nn.Module, min_size: int = 2 ** 14) -> dict:
    """FSDP2 ``fully_shard`` of ``module`` over the mesh's 'data' axis
    (with a DCN axis, HSDP: replicated over 'dcn', sharded over 'data'),
    placed by ``fsdp_param_shardings``; the replicated parameters are
    FSDP2's ``ignored_params``, whose gradients the caller averages. Returns
    the placement by parameter name."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard
    names = batch_axis_names(mesh)
    sub = mesh[names]
    n_data = mesh.size(mesh.mesh_dim_names.index(DATA_AXIS))
    dims = fsdp_param_shardings(module, n_data, min_size)
    by_param = {p: dims[name] for name, p in module.named_parameters()}
    ignored = {p for p, d in by_param.items() if d is None}
    # the flow models return a permuted view; no caller writes into it
    warnings.filterwarnings("ignore", message="FSDP2-wrapped module .* returned a view")
    fully_shard(module, mesh=sub, reshard_after_forward=True,
                shard_placement_fn=lambda p: Shard(by_param[p]),
                ignored_params=ignored or None)
    return dims


def ring_permute_(tensors: list, group) -> list:
    """One hop of the ring, in place: each tensor takes the value that model
    rank −1 holds, and sends its own to model rank +1 (the JAX ``ppermute``
    with perm j → j+1 mod S), one flat buffer per dtype. NCCL sends the
    device buffers (``batch_isend_irecv``); gloo, whose point-to-point
    calls take CPU tensors only, stages them through host memory."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    dst = dist.get_global_rank(group, (me + 1) % n)
    src = dist.get_global_rank(group, (me - 1) % n)
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    host = dist.get_backend(group) == "gloo"
    groups = list(by_dtype.values())
    sends = [torch.cat([t.reshape(-1) for t in ts]) for ts in groups]
    if host:
        sends = [f.cpu() for f in sends]
    recvs = [torch.empty_like(f) for f in sends]
    ops = []
    for tag, (send, recv) in enumerate(zip(sends, recvs)):
        ops += [dist.P2POp(dist.isend, send, dst, group, tag),
                dist.P2POp(dist.irecv, recv, src, group, tag)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    for ts, recv in zip(groups, recvs):
        off = 0
        for t in ts:
            t.copy_(recv[off:off + t.numel()].view_as(t))
            off += t.numel()
    return tensors


def model_all_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every model rank's ``t`` concatenated on ``dim`` in model-rank order
    (the JAX ``all_gather(..., tiled=True)``), on every model rank."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def tp_param_shardings(*args, **kwargs):
    """Tensor-parallel placement: ROADMAP item 13b-ii."""
    _tensor_parallel("tensor-parallel parameter sharding")


def shard_state_tp(*args, **kwargs):
    """Tensor-parallel placement: ROADMAP item 13b-ii."""
    _tensor_parallel("tensor-parallel parameter sharding")
