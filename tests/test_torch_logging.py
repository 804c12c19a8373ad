"""The trainers' metrics log (flocoder_torch.utils.logging) against the JAX
package's shim (its JSONL backend: wandb is installed nowhere here), and
``utils.plot_metrics`` on the port's log.

- The shim alone: the same calls give the same records in both packages
  (``_config`` first, then each record with ``_step`` and ``_t``; tensors,
  numpy scalars and arrays made plain), nothing is written without
  ``init``, and the step counter restarts at ``finish``.
- ``train_flow`` on ``configs/smoke.yaml`` with ``no_wandb=false``, one
  epoch with its evaluation, in both packages, each in a working directory
  of its own (``runs/`` lands there), on the same pre-encoded latents
  (``preencoding.augs_per=1``: 14 steps of 16 an epoch, a val split of
  25):
  every record has the same set of keys, record for record (the values
  differ: the random streams do). ``no_wandb=true`` writes no
  ``runs/``. The JAX script runs on a one-device mesh, as the port does.
- ``plot_metrics`` draws the port's log, and ``load_jsonl`` reads it as the
  JAX function does.
The codec trainers' logs are held in ``test_torch_logging_codecs.py``.
"""
import importlib.util
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from flocoder_tpu.config import load_config as jload_config
from flocoder_tpu.models.unet import Unet as JaxUnet
from flocoder_tpu.ops import fid as jfid
from flocoder_tpu.parallel import mesh as jmesh
from flocoder_tpu.utils import logging as jlog
from flocoder_tpu.utils import plot_metrics as jplot
from flocoder_torch import preencode_data as pe
from flocoder_torch import train_flow as tf
from flocoder_torch.ops import fid as tfid
from flocoder_torch.utils import logging as tlog
from flocoder_torch.utils import plot_metrics as tplot

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load_script(name: str):
    """A root script of the JAX package, imported by its file path."""
    key = f"fc_script_{name}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, os.path.join(ROOT, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key]


def one_device_mesh(monkeypatch):
    """The JAX scripts' ``make_mesh()`` on the first device only."""
    make = jmesh.make_mesh

    def one(*a, **k):
        k.setdefault("devices", jax.devices()[:1])
        return make(*a, **k)

    monkeypatch.setattr(jmesh, "make_mesh", one)


def jit_init(monkeypatch, cls) -> None:
    """``cls.init`` compiled whole: an eager flax init compiles op by op
    (about 20 s for the smoke U-Net on one CPU thread)."""
    plain = cls.init
    monkeypatch.setattr(cls, "init", lambda self, *a: jax.jit(
        lambda *b: plain(self, *b))(*a))


def workdir(path, monkeypatch) -> None:
    """Make ``path`` and run from it."""
    os.makedirs(path, exist_ok=True)
    monkeypatch.chdir(path)


def records(path) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def the_log(workdir) -> str:
    """The one ``metrics.jsonl`` under ``workdir/runs``."""
    found = [os.path.join(r, f) for r, _, fs in os.walk(os.path.join(workdir, "runs"))
             for f in fs if f == "metrics.jsonl"]
    assert len(found) == 1, found
    return found[0]


def assert_same_keys(ours: list, ref: list) -> None:
    """Record for record the same set of keys; the first record is the
    config. (Within a record the order may differ: a jitted JAX step hands
    back its losses with their keys sorted.)"""
    assert list(ours[0]) == list(ref[0]) == ["_config"]
    assert [sorted(r) for r in ours[1:]] == [sorted(r) for r in ref[1:]]
    first = ours[1]["_step"]           # the shim's counter runs on from earlier calls
    assert [r["_step"] for r in ours[1:]] == list(range(first, first + len(ours) - 1))


def test_shim_records_match_jax(tmp_path):
    calls = [({"a": torch.tensor(1.5), "b": np.float32(2.0), "s": "x"}, None),
             ({"loss": np.asarray([1.0, 2.0]), "epoch": 3}, 7),
             ({"c": torch.ones(2)}, None)]
    out = {}
    for name, log in (("t", tlog), ("j", jlog)):
        log.log({"before": 1.0})                      # no log open: nothing written
        log.finish()
        path = log.init(project="p", name=name, config={"lr": np.float64(1e-4), "n": [1, 2]},
                        output_dir=str(tmp_path))
        assert log.is_active()
        for metrics, step in calls:
            log.log(metrics, step=step)
        log.finish()
        assert not log.is_active()
        out[name] = records(tmp_path / "p" / name / "metrics.jsonl")
        assert path is None or path == str(tmp_path / "p" / name / "metrics.jsonl")
    ours, ref = out["t"], out["j"]
    for r in ours + ref:
        r.pop("_t", None)
    assert ours == ref
    assert ours[0] == {"_config": {"lr": 1e-4, "n": [1, 2]}}
    assert [r["_step"] for r in ours[1:]] == [0, 7, 2]


@pytest.fixture(scope="module")
def latents(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lat")
    data = str(tmp / "smoke_data")                   # absent: the synthetic set
    pe.main(["--config-name", "smoke", "+device=cpu", f"data={data}",
             "preencoding.augs_per=1"])
    return data


def test_train_flow_logs_the_jax_keys(latents, tmp_path, monkeypatch):
    over = ["no_wandb=false", "flow.epochs=1", "flow.ckpt_every=1", "flow.n_steps=3",
            "flow.batch_size=16", "flow.dim_mults=[1]", "flow.eval_method=euler", "run_name=r"]
    rp256 = lambda image_size=128: tfid.make_random_projection_features(dim=256)  # noqa: E731
    jrp256 = lambda image_size=128: jfid.make_random_projection_features(dim=256)  # noqa: E731
    monkeypatch.setattr(tfid, "default_feature_fn", rp256)
    monkeypatch.setattr(jfid, "default_feature_fn", jrp256)
    one_device_mesh(monkeypatch)
    jit_init(monkeypatch, JaxUnet)

    workdir(tmp_path / "t", monkeypatch)
    res = tf.main(["--config-name", "smoke", "+device=cpu", f"data={latents}", *over])
    ours = records(res["metrics_log"])

    workdir(tmp_path / "j", monkeypatch)
    cfg = jload_config("smoke", os.path.join(ROOT, "configs"), [f"data={latents}", *over])
    load_script("train_flow").train_flow(cfg)
    ref = records(the_log(tmp_path / "j"))
    # the same project (ldcfg's: the codec section's project_name first) and run
    assert os.path.join(tmp_path / "j", res["metrics_log"]) == the_log(tmp_path / "j")

    assert_same_keys(ours, ref)
    keys = {k for r in ours for k in r}
    assert {"Loss/train", "Learning Rate", "Loss/val", "metrics/FID_px",
            "metrics/FID_feature_backend"} <= keys
    assert any(k.startswith("demo/") for k in keys)
    assert ours[-1]["metrics/FID_feature_backend"] == "rp256"

    # no_wandb=true writes no log
    workdir(tmp_path / "q", monkeypatch)
    tf.main(["--config-name", "smoke", "+device=cpu", f"data={latents}", *over[1:],
             "no_wandb=true", "flow.epochs=0"])
    assert not os.path.exists(tmp_path / "q" / "runs")

    # plot_metrics draws it; load_jsonl reads it as the JAX one does
    run_dir = os.path.dirname(str(tmp_path / "t" / res["metrics_log"]))
    series = tplot.load_jsonl(os.path.join(run_dir, "metrics.jsonl"))
    assert series == jplot.load_jsonl(os.path.join(run_dir, "metrics.jsonl"))
    assert "Loss/train" in series
    # one epoch gives single points; a second run appends to the same log
    monkeypatch.chdir(tmp_path / "t")
    tf.main(["--config-name", "smoke", "+device=cpu", f"data={latents}", *over,
             "flow.no_eval=true"])
    out = tplot.plot_run(run_dir)
    assert out == os.path.join(run_dir, "curves.png") and os.path.getsize(out) > 0
