"""The rank workers of the port's parallel tests (tests/test_torch_parallel_*.py)
and the mesh tests that need no JAX.

This module imports no JAX, so that each spawned rank starts in a couple of
seconds: ``run_ranks`` starts a gloo world of ``world`` CPU ranks with
``torch.multiprocessing`` (spawn), joined through a file under the test's
``tmp_path`` (never a fixed TCP port, as six test workers run at once),
one torch thread a rank; each rank runs one of the ``*_rank`` functions
below and its pickled result comes back to the test (``start_ranks``
returns before the ranks end, so that a test computes its JAX reference
beside them). A rank that raises fails the test with its traceback; a
world that has not ended within the time limit is killed and fails it
too.
"""
import os
import pickle
import socket
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

RANK_TIMEOUT = 150.0


def _entry(rank, fn, world, init_file, out_dir, args, port):
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))
    if port:            # torchrun's way: the environment, through the port's own call
        from flocoder_torch.parallel.mesh import maybe_init_distributed
        os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        maybe_init_distributed(device="cpu")
    else:
        dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                                world_size=world)
    try:
        res = fn(rank, world, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


class Ranks:
    """A started world (``start_ranks``); ``join()`` waits for it and
    returns the ranks' results in rank order."""

    def __init__(self, ctx, out: str, world: int, name: str):
        self.ctx, self.out, self.world, self.name = ctx, out, world, name
        self.deadline = time.time() + RANK_TIMEOUT

    def join(self) -> list:
        while not self.ctx.join(timeout=max(1.0, self.deadline - time.time())):
            if time.time() > self.deadline:
                for p in self.ctx.processes:
                    p.kill()
                raise TimeoutError(f"{self.name} ranks did not end in {RANK_TIMEOUT} s")
        res = []
        for r in range(self.world):
            with open(os.path.join(self.out, f"rank{r}.pkl"), "rb") as f:
                res.append(pickle.load(f))
        return res


def start_ranks(fn, world: int, tmp_path, *args, cwd=None, env_init=False) -> Ranks:
    """Starts ``fn(rank, world, *args)`` on ``world`` gloo ranks and returns
    at once (a test computes its JAX reference meanwhile). ``cwd``: the
    ranks' working directory. ``env_init``: the ranks join as under
    torchrun (``MASTER_ADDR``/``MASTER_PORT``, a free port on localhost)
    through ``maybe_init_distributed``."""
    out = os.path.join(str(tmp_path), f"ranks_{fn.__name__}_{os.urandom(4).hex()}")
    os.makedirs(out)
    port = 0
    if env_init:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
    old = os.getcwd()
    if cwd is not None:
        os.chdir(cwd)
    try:
        ctx = mp.start_processes(_entry, args=(fn, world, os.path.join(out, "init"), out, args,
                                               port),
                                 nprocs=world, join=False, start_method="spawn")
    finally:
        os.chdir(old)
    return Ranks(ctx, out, world, fn.__name__)


def run_ranks(fn, world: int, tmp_path, *args, **kwargs) -> list:
    """``start_ranks`` and ``join``: the ranks' results in rank order."""
    return start_ranks(fn, world, tmp_path, *args, **kwargs).join()


def _np(t):
    return t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) else t


# ---- (a) mesh --------------------------------------------------------------

def mesh_rank(rank, world, n_dcn):
    from flocoder_torch.parallel import mesh as pm
    mesh = pm.make_mesh(n_dcn=n_dcn)
    x = torch.arange(world * 3 * 2, dtype=torch.float32).reshape(world * 3, 2)
    odd = torch.zeros(world * 3 + 1, 2)
    mine = pm.shard_batch(mesh, {"x": x, "odd": odd})
    t = torch.full((3,), float(rank + 1))
    s, m = t.clone(), t.clone()
    pm.psum_([s], mesh)
    pm.pmean_([m], mesh)
    b = pm.broadcast0_(torch.tensor(rank == 0), mesh)
    return {"names": pm.batch_axis_names(mesh), "dims": mesh.mesh_dim_names,
            "n": pm.batch_shard_count(mesh), "rank": pm.batch_rank(mesh),
            "x": mine["x"].numpy(), "odd_shape": tuple(mine["odd"].shape),
            "sum": s.numpy(), "mean": m.numpy(), "bcast": bool(b),
            "gathered": pm.gather_rows(mine["x"], mesh).numpy(),
            "seed": pm.rank_seed(7, mesh), "writer": pm.is_writer(),
            "backend": dist.get_backend()}


def test_mesh_layouts_and_collectives(tmp_path):
    """A 2-rank ('data', 'model') mesh and a 4-rank 2×2 ('dcn', 'data')
    one: the batch axes, the shard count and rank, the rows each rank
    takes (a batch that does not divide stays whole), the sum, mean and
    broadcast over the batch ranks, the gather of every rank's rows, and a
    seed of each rank's own. The 2-rank world joins as under torchrun
    (``maybe_init_distributed`` on the CPU: gloo)."""
    for world, n_dcn in ((2, 1), (4, 2)):
        res = run_ranks(mesh_rank, world, tmp_path, n_dcn, env_init=world == 2)
        x = np.arange(world * 3 * 2, dtype=np.float32).reshape(world * 3, 2)
        for r, out in enumerate(res):
            assert out["dims"] == (("dcn", "data", "model") if n_dcn > 1 else ("data", "model"))
            assert out["names"] == (("dcn", "data") if n_dcn > 1 else "data")
            assert out["n"] == world and out["rank"] == r and out["writer"] == (r == 0)
            np.testing.assert_array_equal(out["x"], x[3 * r:3 * r + 3])
            assert out["odd_shape"] == (world * 3 + 1, 2)
            np.testing.assert_array_equal(out["sum"], np.full(3, world * (world + 1) / 2))
            np.testing.assert_array_equal(out["mean"], np.full(3, (world + 1) / 2))
            assert out["bcast"] is True and out["backend"] == "gloo"
            np.testing.assert_array_equal(out["gathered"], x)
        assert len({out["seed"] for out in res}) == world


def test_single_process_is_the_degenerate_mesh():
    from flocoder_torch.parallel import mesh as pm
    assert pm.make_mesh() is None and pm.batch_shard_count(None) == 1
    x = torch.ones(3, 2)
    assert pm.shard_batch(None, x) is x and pm.gather_rows(x, None) is x
    assert pm.rank_seed(5, None) == 5 and pm.is_writer()
    assert pm.maybe_init_distributed(device="cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="torchrun"):
        pm.make_mesh(n_data=2)
    with pytest.raises(RuntimeError, match="torchrun"):
        pm.make_mesh(n_model=2)         # the model axis needs a world as the data axis does
    with pytest.raises(NotImplementedError, match="ROADMAP.*13b-ii"):
        pm.tp_param_shardings()


# ---- (b) RVQ ---------------------------------------------------------------

def rvq_rank(rank, world, cases):
    """A training call of ``rvq_apply`` on this rank's rows for each
    ``(state, z, seeds, picks, use_mesh)`` of ``cases`` (without the mesh:
    the rank alone)."""
    from flocoder_torch.ops import rvq as trvq
    from flocoder_torch.parallel import mesh as pm
    out = []
    for state, z, seeds, picks, use_mesh in cases:
        mesh = pm.make_mesh() if use_mesh else None
        L, K, D = state["codebooks"].shape
        st = trvq.RVQState(L, K, D)
        st.assign_({k: torch.from_numpy(np.asarray(v)) for k, v in state.items()})
        per = z.shape[0] // world
        zl = torch.from_numpy(z[rank * per:(rank + 1) * per]).requires_grad_(True)
        z_q, idx, loss, new = trvq.rvq_apply(st, zl, train=True, kmeans_seeds=seeds,
                                             reseed_picks=picks, mesh=mesh)
        out.append({"z_q": _np(z_q), "idx": idx.numpy(), "loss": float(loss),
                    "state": {k: v.numpy() for k, v in new.items()}})
    return out


# ---- (c) codec steps -------------------------------------------------------

def codec_rank(rank, world, kind, models, x, overrides, modes, draws):
    """One codec step ('warmup', 'gan', 'dac') on this rank's rows of ``x``
    from the same weights for each ``use_mesh`` of ``modes``, without a
    perceptual net; ``models`` holds the constructors' arguments and state
    dicts."""
    from flocoder_torch.config import load_config
    from flocoder_torch.parallel import mesh as pm
    from flocoder_torch.training import audio as taudio
    from flocoder_torch.training import vqgan as tvqgan
    from flocoder_torch.training.checkpoint import to_jax_flat
    cfg = load_config(models["config"], config_dir="configs", overrides=overrides)
    per = x.shape[0] // world
    xl = torch.from_numpy(x[rank * per:(rank + 1) * per])
    out = []
    for use_mesh in modes:
        mesh = pm.make_mesh() if use_mesh else None
        codec = models["codec_cls"](**models["codec_kw"])
        codec.load_state_dict(models["codec_sd"])
        disc = None
        if models.get("disc_cls") is not None:
            disc = models["disc_cls"](**models["disc_kw"])
            disc.load_state_dict(models["disc_sd"])
        if kind in ("warmup", "gan"):
            state = tvqgan.create_vqgan_state(codec, disc, 1e-4)
            make = tvqgan.make_vqgan_warmup_step if kind == "warmup" else \
                tvqgan.make_vqgan_gan_step
            step = make(cfg, None, mesh=mesh, deterministic=True)
        else:
            state = taudio.create_audio_state(codec, disc, 1e-4)
            step = taudio.make_audio_train_step(cfg, mesh=mesh)
        state, aux, idx = step(state, xl, torch.Generator(), **draws)
        r = {"aux": {k: float(v) for k, v in aux.items()}, "idx": idx.numpy(),
             "codec": to_jax_flat(state.codec, models["prefixes"]),
             "mu": _moments(state.codec, state.opt_g, models["prefixes"])}
        if disc is not None:
            r["disc"] = to_jax_flat(state.disc, models["disc_prefixes"])
            r["disc_mu"] = _moments(state.disc, state.opt_d, models["disc_prefixes"])
        out.append(r)
    return out


def _moments(module, opt, prefixes) -> dict:
    """Adam's first moment of each optimised parameter, laid out as
    ``to_jax_flat`` lays out the module (NaN where there is none)."""
    import copy
    from flocoder_torch.training.checkpoint import to_jax_flat
    m = copy.deepcopy(module)
    with torch.no_grad():
        for pm_, p in zip(m.parameters(), module.parameters()):
            st = opt.state_of(p)
            pm_.copy_(st["exp_avg"] if st else torch.full_like(p, float("nan")))
    return to_jax_flat(m, prefixes)


# ---- (d, e, f) flow steps and sharded checkpoints ---------------------------

def _unet(models):
    from flocoder_torch.models.unet import Unet
    unet = Unet(**models["unet_kw"])
    unet.load_state_dict(models["unet_sd"])
    return unet


def flow_dp_rank(rank, world, models, target, cls, draws, cases, lr):
    """One data-parallel flow step on this rank's rows with its own draws,
    for each ``(drop, use_mesh)`` of ``cases``, from the same weights."""
    from flocoder_torch.parallel import mesh as pm
    from flocoder_torch.training import flow as tflow
    from flocoder_torch.training.checkpoint import UNET_PREFIXES, adam_to_jax_flat, to_jax_flat
    out = []
    for drop, use_mesh in cases:
        mesh = pm.make_mesh() if use_mesh else None
        state = tflow.create_flow_state(_unet(models), lr)
        step = tflow.make_flow_train_step(mesh=mesh, ema_decay=0.9)
        per = target.shape[0] // world
        rows = slice(rank * per, (rank + 1) * per)
        batch = {"target": torch.from_numpy(target[rows]),
                 "class_cond": torch.from_numpy(cls[rows]).long()}
        state, aux = step(state, batch, None, draws=[draws[rank]], drop=torch.tensor(drop))
        out.append({"aux": {k: float(v) for k, v in aux.items()},
                    "params": to_jax_flat(state.model, UNET_PREFIXES),
                    "ema": to_jax_flat(state.ema, UNET_PREFIXES),
                    "opt": adam_to_jax_flat(state.model, state.opt.adam, state.step,
                                            UNET_PREFIXES)})
    return out


def flow_fsdp_rank(rank, world, models, target, cls, steps, lr, min_size, ckpt_dir, modes):
    """For each of ``modes``: ``len(steps)`` flow steps (``steps``: per step
    the global draws and the gate) on this rank's rows of the global batch,
    the FSDP step (``True``; with ``ckpt_dir``, a sharded checkpoint after
    them) or the data-parallel step on the same rows and their draws
    (``False``)."""
    from flocoder_torch import train_flow as tf
    from flocoder_torch.parallel import mesh as pm
    from flocoder_torch.training import flow as tflow
    from flocoder_torch.training.checkpoint import (UNET_PREFIXES, adam_to_jax_flat,
                                                    save_checkpoint_sharded, to_jax_flat)
    mesh = pm.make_mesh()
    per = target.shape[0] // world
    rows = slice(rank * per, (rank + 1) * per)
    batch = {"target": torch.from_numpy(target[rows]),
             "class_cond": torch.from_numpy(cls[rows]).long()}
    out = []
    for fsdp in modes:
        state = tflow.create_flow_state(_unet(models), lr)
        dims = tflow.shard_flow_state(state, mesh, min_size=min_size) if fsdp else {}
        step = tflow.make_flow_train_step(mesh=mesh, fsdp=fsdp)
        auxs = []
        for draws, drop in steps:
            if not fsdp:
                draws = {k: v[rows] for k, v in draws.items()}
            state, aux = step(state, batch, None, draws=[draws], drop=torch.tensor(drop))
            auxs.append({k: float(v) for k, v in aux.items()})
        path, resumed = None, None
        if fsdp and ckpt_dir is not None:
            path = save_checkpoint_sharded(tf._sharded_tree(state), len(steps),
                                           ckpt_dir=ckpt_dir)
            # the resume path: the whole optimizer state into a fresh sharded one
            fresh = tflow.create_flow_state(_unet(models), lr)
            tflow.shard_flow_state(fresh, mesh, min_size=min_size)
            tf._load_opt(fresh, tf._opt_flat(state))
            fresh.step = state.step          # train_flow sets it from the epoch
            resumed = tf._opt_flat(fresh)
        out.append({"aux": auxs, "dims": dims, "path": path, "resumed": resumed,
                    "n_sharded": sum(hasattr(p, "to_local") for p in state.model.parameters()),
                    "params": to_jax_flat(state.model, UNET_PREFIXES),
                    "ema": to_jax_flat(state.ema, UNET_PREFIXES),
                    "opt": adam_to_jax_flat(state.model, state.opt.adam, state.step,
                                            UNET_PREFIXES)})
    return out


# ---- (g) sharded serving ---------------------------------------------------

def serving_rank(rank, world, models, codec_models, n_classes, n_steps, conds, seed):
    """For each class condition of ``conds`` (``None``: the class grid),
    ``sampler`` of a batch of 8 on the mesh from this rank's stream; then a
    batch of 3, which does not split."""
    from flocoder_torch.evaluation import sampler
    from flocoder_torch.parallel import mesh as pm
    mesh = pm.make_mesh()
    codec = codec_models["codec_cls"](**codec_models["codec_kw"])
    codec.load_state_dict(codec_models["codec_sd"])
    codec.eval()
    kw = dict(n_steps=n_steps, n_classes=n_classes, latent_shape=models["latent_shape"],
              mesh=mesh)
    out = {"seed": pm.rank_seed(seed, mesh), "runs": []}
    for cond in conds:
        gen = torch.Generator().manual_seed(pm.rank_seed(seed, mesh))
        cond = None if cond is None else {"class_cond": torch.from_numpy(cond).long()}
        lat, dec, nfe = sampler(_unet(models), codec, gen, batch_size=8, cond=cond, **kw)
        out["runs"].append({"latents": lat.numpy(), "images": dec.numpy(), "nfe": nfe})
    gen = torch.Generator().manual_seed(pm.rank_seed(seed, mesh))
    out["odd"] = sampler(_unet(models), codec, gen, batch_size=3, **kw)[1].numpy()
    return out


# ---- (h) the entry points --------------------------------------------------

def script_rank(rank, world, module, argv, rp_dim):
    """``flocoder_torch.<module>.main(argv)`` on this rank (the FID
    features at ``rp_dim`` random projections when given, as the
    single-process tests patch them)."""
    import importlib
    if rp_dim:
        from flocoder_torch.ops import fid as tfid
        tfid.default_feature_fn = lambda image_size=128: \
            tfid.make_random_projection_features(dim=rp_dim)
    res = importlib.import_module(f"flocoder_torch.{module}").main(argv)
    keep = ("epochs", "epoch_seconds", "eval", "checkpoint", "ema_checkpoint", "ranks",
            "fsdp", "sharded", "device", "val", "step_seconds", "model_axis", "ring")
    out = {k: res[k] for k in keep if isinstance(res, dict) and k in res}
    if module == "preencode_data":
        out = {split: {k: v for k, v in res[split].items()} for split in ("val", "train")}
    if module == "train_flow":
        out["n_dtensor"] = sum(hasattr(p, "to_local") for p in res["state"].model.parameters())
    return out


# ---- (i) the model axis: ring attention -------------------------------------

def _layout(mesh) -> dict:
    from flocoder_torch.parallel import mesh as pm
    return {"dims": mesh.mesh_dim_names, "shape": tuple(mesh.shape),
            "coord": list(mesh.get_coordinate()), "batch_rank": pm.batch_rank(mesh),
            "model_rank": pm.model_rank(pm.model_group(mesh)),
            "n_batch": pm.batch_shard_count(mesh), "seed": pm.rank_seed(7, mesh)}


def ring_op_rank(rank, world, cases, flop_qkv):
    """The ring on a 1×``world`` mesh: for each case of ``cases`` (``q``,
    ``k``, ``v`` and the cotangent ``w`` as numpy, ``dtype``, ``axis_size``
    and ``kind``: 'replicated', whole tensors, or 'sharded', each rank its
    token chunk) the output, the gradients of sum(out·w), the hops and the
    all-gathers of each direction, or the error a case raises; then the
    backward FLOPs of the ring and of plain attention on ``flop_qkv``."""
    from torch.utils.flop_counter import FlopCounterMode
    from flocoder_torch.parallel import mesh as pm
    from flocoder_torch.parallel import ring_attention as ra
    mesh = pm.make_mesh(n_model=world)
    gathers = [0]
    real = ra.model_all_gather

    def counting(t, dim, group):
        gathers[0] += 1
        return real(t, dim, group)

    ra.model_all_gather = counting
    out = {"layout": _layout(mesh), "cases": []}
    for c in cases:
        dt = getattr(torch, c["dtype"])
        q, k, v = (torch.from_numpy(c[n]).to(dt) for n in "qkv")
        w = torch.from_numpy(c["w"])
        if c["kind"] == "sharded":
            q, k, v, w = (ra._chunk(t, rank, world) for t in (q, k, v, w))
        q, k, v = (t.clone().requires_grad_(True) for t in (q, k, v))
        ra.reset_hops()
        gathers[0] = 0
        try:
            o = (ra.make_ring_self_attention()(q, k, v) if c["kind"] == "sharded" else
                 ra.ring_attention_replicated(q, k, v, c["axis_size"]))
        except ValueError as e:
            out["cases"].append({"error": str(e)})
            continue
        fwd_hops, fwd_gathers = ra.HOPS["forward"], gathers[0]
        (o.float() * w).sum().backward()
        out["cases"].append({"out": o.detach().float().numpy(), "dtype": str(o.dtype),
                             "grads": [t.grad.float().numpy() for t in (q, k, v)],
                             "grad_dtypes": [str(t.grad.dtype) for t in (q, k, v)],
                             "hops": [fwd_hops, ra.HOPS["backward"]],
                             "gathers": [fwd_gathers, gathers[0] - fwd_gathers]})
    flops = {}
    for name in ("ring", "plain"):
        q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in flop_qkv)
        o = (ra.ring_attention_replicated(q, k, v, world) if name == "ring"
             else ra._plain_attention(q, k, v))
        with FlopCounterMode(display=False) as fc:
            (o ** 2).sum().backward()
        flops[name] = fc.get_total_flops()
    out["flops"] = flops
    return out


def _grads_flat(module, prefixes) -> dict:
    """The gradients of ``module``'s parameters, laid out as ``to_jax_flat``
    lays out the module."""
    import copy
    from flocoder_torch.training.checkpoint import to_jax_flat
    m = copy.deepcopy(module)
    with torch.no_grad():
        for pm_, p in zip(m.parameters(), module.parameters()):
            pm_.copy_(p.grad if p.grad is not None else torch.zeros_like(p))
    return to_jax_flat(m, prefixes)


def ring_models_rank(rank, world, cases):
    """Each case's module (``build``: 'unet', 'hdit' or 'decoder' with its
    ``kw``) on the 1×``world`` mesh, its weights the JAX flat tree ``flat``
    (prefix ``params``), built with the ring and without: the outputs on
    ``inputs`` and the parameters' gradients of sum(out·w)."""
    from flocoder_torch.models import codecs as tc
    from flocoder_torch.models import hdit as th
    from flocoder_torch.models.unet import Unet
    from flocoder_torch.parallel import mesh as pm
    from flocoder_torch.parallel import ring_attention as ra
    from flocoder_torch.training.checkpoint import load_jax_flat
    pm.make_mesh(n_model=world)
    prefixes = {"": "params"}
    out = []
    for c in cases:
        res = {}
        for ring in (world, 1):
            kw = dict(c["kw"], ring_axis_size=ring)
            if c["build"] == "hdit":
                levels = tuple(th.LevelSpec(d, w, f, th.NeighborhoodAttentionSpec(8, 3)
                                            if a == "na" else th.GlobalAttentionSpec(8))
                               for d, w, f, a in kw.pop("levels"))
                m = th.HDiT(levels, th.MappingSpec(*kw.pop("mapping")), **kw)
            else:
                m = {"unet": Unet, "decoder": tc.VQVAEDecoder}[c["build"]](**kw)
            load_jax_flat(m, c["flat"], prefixes)
            args = [torch.from_numpy(a) for a in c["inputs"]]
            if c["build"] != "decoder":
                args.append({"class_cond": None, "mask_cond": None})
            ra.reset_hops()
            o = m(*args)
            (o * torch.from_numpy(c["w"])).sum().backward()
            res[ring] = {"out": o.detach().numpy(), "grads": _grads_flat(m, prefixes),
                         "hops": [ra.HOPS["forward"], ra.HOPS["backward"]]}
        out.append(res)
    return out


def ring_flow_rank(rank, world, n_model, models, target, cls, draws, drop, lr):
    """One flow step of the HDiT of ``models`` on a (world/n_model)×n_model
    mesh, its ring twin trained (``ring_twin``): this rank's rows of the
    global batch by its batch rank, that batch rank's ``draws``; the mesh
    layout, the state after the step and Adam's first moments."""
    from flocoder_torch.models import hdit as th
    from flocoder_torch.models.flow_model import ring_twin
    from flocoder_torch.parallel import mesh as pm
    from flocoder_torch.training import flow as tflow
    from flocoder_torch.training.checkpoint import UNET_PREFIXES, adam_to_jax_flat, to_jax_flat
    mesh = pm.make_mesh(n_model=n_model)
    model = th.HDiT(**models["kw"])
    model.load_state_dict(models["sd"])
    twin = ring_twin(model, n_model)
    state = tflow.create_flow_state(model, lr)
    step = tflow.make_flow_train_step(mesh=mesh, ema_decay=0.9,
                                      model_apply=lambda m, x, t, c: twin(x, t, c))
    b = pm.batch_rank(mesh)
    batch = pm.shard_batch(mesh, {"target": torch.from_numpy(target),
                                  "class_cond": torch.from_numpy(cls).long()})
    state, aux = step(state, batch, None, draws=[draws[b]], drop=torch.tensor(drop))
    return {"layout": _layout(mesh), "aux": {k: float(v) for k, v in aux.items()},
            "params": to_jax_flat(state.model, UNET_PREFIXES),
            "ema": to_jax_flat(state.ema, UNET_PREFIXES),
            "opt": adam_to_jax_flat(state.model, state.opt.adam, state.step, UNET_PREFIXES)}
