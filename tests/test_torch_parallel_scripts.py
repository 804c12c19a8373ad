"""The entry points on 2 gloo ranks at the smoke size (``smoke_vqgan``:
synthetic 32² images, the VQGAN codec with seeded random weights, 8×8×4
latents), ``+device=cpu``: ``preencode_data`` with the fused RVQ (each
rank encodes its rows, rank 0 writes) writes the files a one-process run
writes, byte for byte; ``train_flow`` trains an epoch data-parallel with
its sharded evaluation, and an epoch with ``flow.fsdp=true`` and
``flow.sharded_checkpoints=true``, whose files the JAX loader reassembles.
``train_vqgan`` runs in ``test_torch_parallel_codec_scripts.py``.
"""
import os

import numpy as np
import pytest
import torch

from flocoder_tpu.training.checkpoint import load_checkpoint_sharded as jax_load_sharded
from flocoder_torch import preencode_data as pe
from test_torch_parallel_ranks import script_rank, start_ranks

PE = ["--config-name", "smoke_vqgan", "+device=cpu", "preencoding.quantize=true",
      "preencoding.fused_vq=true", "preencoding.augs_per=1", "preencoding.batch_size=8"]
FLOW = ["--config-name", "smoke_vqgan", "+device=cpu", "flow.batch_size=16", "flow.epochs=1",
        "flow.ckpt_every=1", "flow.dim_mults=[1,2]", "flow.n_steps=3"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return out


@pytest.fixture(scope="module")
def encoded(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pe")
    one, two = tmp / "one" / "synth", tmp / "two" / "synth"
    ranks = start_ranks(script_rank, 2, tmp, "preencode_data", [*PE, f"data={two}"], 0)
    ref = pe.main([*PE, f"data={one}"])
    return dict(tmp=tmp, one=one, two=two, ref=ref, res=ranks.join())


def test_two_rank_preencode_writes_one_process_files(encoded):
    ref = _files(f"{encoded['one']}_encoded_vqgan")
    ours = _files(f"{encoded['two']}_encoded_vqgan")
    assert len(ref) == encoded["ref"]["train"]["latents"] + encoded["ref"]["val"]["latents"]
    assert sorted(ours) == sorted(ref)
    assert all(ours[k] == ref[k] for k in ref)
    for split in ("val", "train"):
        assert encoded["ref"][split]["quantize"] == "fused"
        assert [r[split]["latents"] for r in encoded["res"]] == [
            encoded["ref"][split]["latents"]] * 2
        assert encoded["res"][1][split]["bytes"] == 0        # rank 0 alone writes


def test_two_rank_train_flow(encoded):
    tmp, data = encoded["tmp"], str(encoded["two"])
    dp = start_ranks(script_rank, 2, tmp, "train_flow",
                     [*FLOW, f"data={data}", f"+ckpt_dir={tmp}/ck", f"+output_dir={tmp}/out"],
                     256)
    fs = start_ranks(script_rank, 2, tmp, "train_flow",
                     [*FLOW, f"data={data}", f"+ckpt_dir={tmp}/ck2", f"+output_dir={tmp}/out2",
                      "flow.no_eval=true", "flow.fsdp=true", "flow.sharded_checkpoints=true"],
                     0)
    dp, fs = dp.join(), fs.join()
    n_train = encoded["ref"]["train"]["latents"]
    for r in dp:
        assert r["ranks"] == 2 and not r["fsdp"] and r["n_dtensor"] == 0
        (eps,) = r["epoch_seconds"]
        assert eps["steps"] == n_train // 16 and eps["samples"] == eps["steps"] * 16
        (ev,) = r["eval"]
        assert ev["metrics"]["FID_feature_backend"] == "rp256"
    for k in ("loss", "grad_norm"):
        assert np.isfinite(dp[0]["epochs"][0][k])
        assert dp[0]["epochs"][0][k] == dp[1]["epochs"][0][k]
    assert dp[0]["eval"][0]["metrics"] == dp[1]["eval"][0]["metrics"]
    assert os.path.basename(dp[0]["checkpoint"]) == "flow_1.npz" and dp[1]["checkpoint"] is None
    assert "decoded_pred_rk4_8_epoch1.png" in os.listdir(f"{tmp}/out")

    for r in fs:
        assert r["ranks"] == 2 and r["fsdp"] and r["ema_checkpoint"] is None
        assert np.isfinite(r["epochs"][0]["loss"])
    assert sorted(os.listdir(f"{tmp}/ck2")) == ["flow_1.host0.npz", "flow_1.host1.npz"]
    state = jax_load_sharded(f"{tmp}/ck2", "flow_", 1)["state"]
    assert set(state) == {"params", "opt_state", "ema"}
