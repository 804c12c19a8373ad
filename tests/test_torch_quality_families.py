"""Each family of the port's quality-runs tool (flocoder_torch.quality_runs)
at a tiny budget on the CPU writes the JAX tool's payload: every key of the
committed JAX artifact (eval_out/quality/<family>.json), nested ones alike,
and besides them only the sizes, the device, the JAX artifact's path and
(image) the FID backend; every number finite; the sizes as run. The image
family scores FID on rp features at 256 dimensions here (a 2048-wide
Newton–Schulz root is slow on one CPU thread)."""
import json
import math
import os

import pytest
import torch

from flocoder_torch import quality_runs as tq
from flocoder_torch.ops.fid import make_random_projection_features

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXTRA = {"sizes", "device", "jax_artifact"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TINY = {
    "unet_vs_hdit": dict(steps=2, hdit_budget_x=2, eval_steps=2),
    "meanflow": dict(steps=2, eval_steps=2),
    "reflow": dict(steps=3, pair_batches=2, eval_steps=2),
    "audio": dict(steps=2, gan_steps=2),
    "image": dict(steps=2, hdit_budget_x=1, reflow_steps=2, pair_batches=1, eval_steps=2),
}


def _same_keys(ours, ref, where):
    if isinstance(ref, dict):
        assert isinstance(ours, dict) and set(ours) == set(ref), (where, set(ours) ^ set(ref))
        for k in ref:
            _same_keys(ours[k], ref[k], f"{where}.{k}")


def _numbers(node):
    if isinstance(node, dict):
        for v in node.values():
            yield from _numbers(v)
    elif isinstance(node, list):
        for v in node:
            yield from _numbers(v)
    elif isinstance(node, (int, float)) and not isinstance(node, bool):
        yield node


@pytest.mark.parametrize("family", sorted(TINY))
def test_family_writes_the_jax_payload(family, tmp_path):
    kw = dict(TINY[family])
    if family == "image":
        kw["feature_fn"] = make_random_projection_features(dim=256, image_size=tq.IMG_SIZE)
    tq.FAMILIES[family](**kw, device="cpu", out=str(tmp_path))
    with open(tmp_path / f"{family}.json") as f:
        ours = json.load(f)
    with open(os.path.join(REPO, "eval_out", "quality", f"{family}.json")) as f:
        ref = json.load(f)
    extra = EXTRA | ({"fid_backend"} if family == "image" else set())
    assert set(ours) == set(ref) | extra, set(ours) ^ (set(ref) | extra)
    for k in ref:
        _same_keys(ours[k], ref[k], k)
    assert all(math.isfinite(v) for v in _numbers(ours))
    sizes = {k: v for k, v in TINY[family].items()}
    assert ours["sizes"] == sizes and ours["steps"] == sizes["steps"]
    assert ours["device"] == {"type": "cpu"}
    assert ours["jax_artifact"] == f"eval_out/quality/{family}.json"
    if family == "image":
        assert ours["fid_backend"] == "rp256" and ours["reflow_steps"] == 2
        assert ours["summary"]["meanflow_1nfe"]["nfe"] == 1
    pngs = [n for n in os.listdir(tmp_path) if n.endswith(".png")]
    assert pngs, "no sample grid written"
