"""The port's reflow-pairs tool against the JAX package's
``tools/make_reflow_pairs.py`` on the same tiny teacher checkpoint (the
U-Net of the JAX tool's own test, ``tests/test_e2e_scripts.py``: 8×8×3
resize latents, 4 classes, seeded random weights), on the CPU.

- Both write the same tree: the file names, the split counts, the label
  directories (the labels come from ``np.random.default_rng(seed)`` in
  both), exactly the keys ``target_latents`` and ``source_latents``,
  float32, of the latents' shape; every batch is full and the last one's
  surplus is dropped. Only the noise differs (Philox against threefry).
- Each package's ``PreEncodedDataset`` and ``Loader`` read either tree into
  the same batches (targets, sources, labels).
- A non-empty ``out_dir`` is refused.
"""
import functools
import importlib.util
import os
import sys

import jax
import numpy as np
import pytest
import torch

from flocoder_tpu.config import config_from_dict as jconfig_from_dict
from flocoder_tpu.data import datasets as jdata
from flocoder_tpu.models.unet import Unet as JaxUnet
from flocoder_tpu.training.checkpoint import save_checkpoint as jsave_checkpoint
from flocoder_torch import make_reflow_pairs as mrp
from flocoder_torch.config import Config
from flocoder_torch.data import datasets as tdata
from test_torch_reflow import ROOT, UNET_CFG, random_params


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_tool(monkeypatch):
    """tools/make_reflow_pairs.py, whose ``import generate_samples`` must
    find the repo's script."""
    spec = importlib.util.spec_from_file_location("fc_script_generate_samples",
                                                  os.path.join(ROOT, "generate_samples.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    monkeypatch.setitem(sys.modules, "generate_samples", gen)
    spec = importlib.util.spec_from_file_location(
        "fc_tool_reflow", os.path.join(ROOT, "tools", "make_reflow_pairs.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def _tree(out_dir):
    files = sorted(os.path.relpath(os.path.join(d, f), out_dir)
                   for d, _, fs in os.walk(out_dir) for f in fs)
    out = {}
    for f in files:
        with np.load(os.path.join(out_dir, f)) as z:
            out[f] = {k: (z[k].shape, z[k].dtype) for k in z.files}
    return out


@pytest.fixture(scope="module")
def pair_trees(tmp_path_factory):
    """The U-Net teacher's checkpoint and both tools' trees from it."""
    tmp = tmp_path_factory.mktemp("reflow")
    params = random_params(JaxUnet(dim=8, channels=3, dim_mults=(1, 2), n_classes=4),
                           (8, 8, 3), 3)
    ckpt = jsave_checkpoint({"model": {"params": params}}, 1, ckpt_dir=str(tmp),
                            prefix="flowema_", config=jconfig_from_dict(UNET_CFG))
    keys = dict(flow_checkpoint=ckpt, n_pairs=44, batch_size=8, n_steps=3, method="euler",
                val_frac=0.1, seed=5)
    with pytest.MonkeyPatch.context() as mp:
        # the JAX serving loader's U-Net init, jitted whole: the same
        # values, where the eager init compiles each of its ops (24 s here)
        eager = JaxUnet.init
        mp.setattr(JaxUnet, "init", lambda self, *a: jax.jit(
            functools.partial(eager, self))(*a))
        tool = _jax_tool(mp)
        sys.modules["generate_samples"]._MODEL_CACHE.clear()
        tool.make_reflow_pairs(jconfig_from_dict({**keys, "out_dir": str(tmp / "jax")}))
    res = mrp.make_reflow_pairs(Config({**keys, "out_dir": str(tmp / "port")}), device="cpu")
    return dict(tmp=tmp, ckpt=ckpt, keys=keys, res=res, jax=str(tmp / "jax"),
                port=str(tmp / "port"))


def test_port_and_jax_tools_write_the_same_tree(pair_trees):
    res = pair_trees["res"]
    ours, ref = _tree(pair_trees["port"]), _tree(pair_trees["jax"])
    assert list(ours) == list(ref)
    assert ours == ref
    assert all(v == {"target_latents": ((8, 8, 3), np.float32),
                     "source_latents": ((8, 8, 3), np.float32)} for v in ours.values())
    n_val = sum(f.startswith("val/") for f in ours)
    assert (res["train"], res["val"]) == (len(ours) - n_val, n_val) == (40, 4)
    assert res["batches"] == 6 and res["nfe"] == 2 and res["out_dir"] == pair_trees["port"]
    labels = {f.split(os.sep)[1] for f in ours}
    assert labels <= {"0000", "0001", "0002", "0003"} and len(labels) > 1
    # the last batch's surplus is dropped: 44 pairs of 6 batches of 8
    assert max(os.path.basename(f) for f in ours if "b000005_" in f) == "b000005_003.npz"
    with pytest.raises(SystemExit, match="not empty"):
        mrp.make_reflow_pairs(Config({**pair_trees["keys"], "out_dir": pair_trees["port"]}),
                              device="cpu")


@pytest.mark.parametrize("which", ["port", "jax"])
def test_both_loaders_read_either_tree_alike(pair_trees, which):
    path = os.path.join(pair_trees[which], "train")
    tl = tdata.Loader(tdata.PreEncodedDataset(path), 8, num_workers=1, seed=0)
    jl = jdata.Loader(jdata.PreEncodedDataset(path), 8, shuffle=True, num_workers=1, seed=0)
    n = 0
    for tb, jb in zip(tl, jl):
        assert set(tb) == set(jb) == {"target", "source", "class_cond"}
        for k in tb:
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
        assert not np.array_equal(tb["target"], tb["source"])
        n += 1
    assert n == len(tl) == 5
