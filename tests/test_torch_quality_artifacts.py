"""The port's committed quality artifacts (eval_out/quality_torch/*.json,
written by ``python -m flocoder_torch.quality_runs`` on the card) held to
the pins that tests/test_quality_regression.py sets for the JAX tool's
artifacts (pod excepted: it waits for the parallel layer), family by
family, and to the sizes of the JAX artifact each is read against."""
import json
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QDIR = os.path.join(REPO, "eval_out", "quality_torch")


def _load(name):
    path = os.path.join(QDIR, f"{name}.json")
    if not os.path.exists(path):
        pytest.fail(f"missing committed quality artifact {path} — run "
                    "python -m flocoder_torch.quality_runs on the card")
    with open(path) as f:
        return json.load(f)


def _unet_vs_hdit(d):
    s = d["summary"]
    assert d["steps"] == 800 and d["batch"] == 64
    assert s["unet_loss_floor"] < 0.25
    assert s["unet_rk4_50"]["separation"] > 2.2
    assert s["unet_rk4_50"]["center_abs_err"] < 0.4
    assert s["hdit_rk4_50_converged"]["separation"] > 2.2
    assert s["hdit_rk4_50_converged"]["center_abs_err"] < 0.3
    assert "hdit_rk4_50_equal_budget" in s
    base = s["data_vs_data_sinkhorn"]
    assert s["unet_rk4_50"]["sinkhorn_latent"] < 12 * max(base, 1.0)
    assert s["hdit_rk4_50_converged"]["sinkhorn_latent"] < 12 * max(base, 1.0)


def _meanflow(d):
    s = d["summary"]
    mf = s["meanflow_1nfe"]
    assert mf["nfe"] == 1
    assert mf["separation"] > 2.2
    assert mf["center_abs_err"] < 0.3
    assert s["flow_loss_floor"] < 0.25
    assert s["rk4_50"]["separation"] > 2.2


def _reflow(d):
    s = d["summary"]
    r = s["reflow_euler5"]
    assert r["nfe"] == 4
    assert r["separation"] > 2.2
    assert r["center_abs_err"] < 0.4
    assert r["sinkhorn_latent"] <= 1.25 * s["base_euler5"]["sinkhorn_latent"]
    assert s["reflow_loss_floor"] < 0.1


def _audio(d):
    s = d["summary"]
    assert s["total_loss_floor"] < 0.55 * s["first_loss"]
    assert s["mel_loss_floor"] < 2.5
    assert s["recon_components"]["vq"] < 0.05
    g = s["gan_components"]
    assert g["d_loss"] < 1.5
    assert g["feat"] < 1.0
    assert g["wave_l1"] <= 1.15 * s["recon_components"]["wave_l1"]
    assert abs(s["snr_gain_db"]) < 3.0
    assert s["gan_mel"] < 2.5


def _image(d):
    s = d["summary"]
    assert d["steps"] == 800 and d["batch"] == 64
    assert s["fid_data_vs_data"] < 5
    assert s["sinkhorn_data_vs_data"] < 10
    u = s["unet_rk4_50"]
    assert u["color_acc"] > 0.9
    assert u["fid_px"] < 170
    assert u["sinkhorn_latent"] < 15 * max(s["sinkhorn_data_vs_data"], 1.0)
    mf = s["meanflow_1nfe"]
    assert mf["nfe"] == 1
    assert mf["color_acc"] > 0.9
    assert mf["fid_px"] < 1.25 * u["fid_px"]
    b5 = s["base_euler5"]
    r5 = s["reflow_euler5"]
    assert b5["color_acc"] > 0.9 and r5["color_acc"] > 0.9
    assert b5["fid_px"] < 1.25 * u["fid_px"]
    assert r5["fid_px"] < 1.4 * b5["fid_px"]
    h = s["hdit_rk4_50_converged"]
    assert h["color_acc"] > 0.9
    assert h["fid_px"] < 1.1 * u["fid_px"]
    assert "hdit_rk4_50_equal_budget" in s


PINS = {"unet_vs_hdit": _unet_vs_hdit, "meanflow": _meanflow, "reflow": _reflow,
        "audio": _audio, "image": _image}


@pytest.mark.parametrize("family", sorted(PINS))
def test_port_artifact_holds_the_jax_pins(family):
    d = _load(family)
    PINS[family](d)


@pytest.mark.parametrize("family", sorted(PINS))
def test_port_artifact_was_run_at_the_jax_artifacts_sizes(family):
    """Measured on the card, at the sizes of the JAX artifact it names (the
    image family at 800 and 400 steps, as eval_out/quality/image.json, not
    the JAX tool's defaults of 600 and 300), and on rp2048 for FID."""
    d = _load(family)
    with open(os.path.join(REPO, d["jax_artifact"])) as f:
        ref = json.load(f)
    assert d["jax_artifact"] == f"eval_out/quality/{family}.json"
    assert d["device"]["type"] == "cuda" and d["device"]["nvidia_smi"]
    for k in ("steps", "batch", "gan_steps", "pair_batches", "hdit_steps", "reflow_steps"):
        if k in ref:
            assert d[k] == ref[k], k
    assert d["sizes"].get("eval_steps", 50) == 50
    if family == "image":
        assert d["fid_backend"] == "rp2048"
