"""The port's sampler web UI (flocoder_torch.ui.webapp) against the JAX
package's (flocoder_tpu.ui.webapp), each server in a thread: the form page
is the same bytes for the same config, a missing file is a 404, a bad
checkpoint is reported as ERROR on the page, a POST on a tiny seeded
``flowers_vqgan``-shaped checkpoint (32² images, hidden 32, 8×8×4 latents,
a U-Net of dim 8) on the CPU writes the PNGs that ``generate_samples``
writes for the same settings (byte for byte) and serves them back as
image/png, and ``+use_gradio=true`` serves the UI instead of raising."""
import os
import threading
import urllib.error
import urllib.parse
import urllib.request

import pytest
import torch

from flocoder_torch import generate_samples as gs
from flocoder_torch.config import config_from_dict, load_config, parse_cli, to_dict
from flocoder_torch.models.codecs import NATTENBlock, setup_codec
from flocoder_torch.models.layers import init_params
from flocoder_torch.models.unet import Unet
from flocoder_torch.training.checkpoint import (UNET_PREFIXES, VQVAE_PREFIXES,
                                                save_checkpoint, to_jax_flat)
from flocoder_torch.ui import webapp
from flocoder_tpu.config import config_from_dict as jax_config_from_dict
from flocoder_tpu.ui import webapp as jax_webapp


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TINY = ["codec.image_size=32", "image_size=32", "codec.hidden_channels=32",
        "codec.internal_dim=32", "codec.num_downsamples=2", "codec.vq_num_embeddings=16"]


def _serve(module, cfg, out_dir):
    server = module.create_app(cfg, out_dir=str(out_dir))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_address[1]}"


def _stop(server):
    server.shutdown()
    server.server_close()


def _post(base, **form):
    data = urllib.parse.urlencode(form).encode()
    return urllib.request.urlopen(base + "/generate", data=data, timeout=300).read().decode()


def _write_checkpoints(tmp_path):
    """Seeded random-init codec and flow checkpoints for ``flowers_vqgan``
    at TINY, written with the port's save_checkpoint."""
    codec_path = str(tmp_path / "vqgan_0.npz")
    cfg = load_config("flowers_vqgan", config_dir=gs.CONFIG_DIR,
                      overrides=[*TINY, f"codec.checkpoint={codec_path}"])
    codec = init_params(setup_codec(cfg), torch.Generator().manual_seed(0))
    for m in codec.modules():
        if isinstance(m, NATTENBlock):
            m.gamma.data.fill_(1.0)
    save_checkpoint(to_jax_flat(codec, VQVAE_PREFIXES), 0, ckpt_dir=str(tmp_path),
                    prefix="vqgan_")
    unet = init_params(Unet(dim=8, channels=4), torch.Generator().manual_seed(1))
    return save_checkpoint(to_jax_flat(unet, UNET_PREFIXES), 0, ckpt_dir=str(tmp_path),
                           prefix="flowema_", config=cfg)


def test_form_page_is_the_jax_pages_bytes(tmp_path):
    settings = {"n_steps": 8, "seed": 1, "method": "heun", "init_image": "a<b>.png"}
    ours, base = _serve(webapp, config_from_dict(settings), tmp_path / "ours")
    ref, ref_base = _serve(jax_webapp, jax_config_from_dict(settings), tmp_path / "ref")
    try:
        page = urllib.request.urlopen(base + "/", timeout=10).read()
        assert page == urllib.request.urlopen(ref_base + "/", timeout=10).read()
        text = page.decode()
        for field in ("ckpt", "n_samples", "cfg", "method", "steps", "seed", "init_image",
                      "init_strength"):
            assert f'name="{field}"' in text
        for m in webapp.METHODS:
            assert f'value="{m}"' in text
        assert '<option value="heun" selected>' in text
        status = urllib.request.urlopen(base + "/status", timeout=10)
        assert status.headers["Content-Type"] == "application/json"
        assert status.read() == b'"idle"'
    finally:
        _stop(ours)
        _stop(ref)


def test_missing_file_is_404(tmp_path):
    server, base = _serve(webapp, config_from_dict({}), tmp_path / "out")
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(base + "/files/nope.png", timeout=10)
        assert e.value.code == 404
    finally:
        _stop(server)


def test_bad_checkpoint_reports_error(tmp_path):
    server, base = _serve(webapp, config_from_dict({"device": "cpu"}), tmp_path / "out")
    try:
        page = _post(base, ckpt="/nonexistent.npz", n_samples=2, cfg=1.0, method="rk4",
                     steps=4, seed=0)
        assert "ERROR" in page and "flow checkpoint not found" in page
    finally:
        _stop(server)


def test_post_serves_what_generate_samples_writes(tmp_path):
    flow = _write_checkpoints(tmp_path)
    config = parse_cli(["--config-name", "flowers_vqgan", *TINY, "+device=cpu",
                        f"+flow_checkpoint={flow}", "+init_image=/nonexistent.png"],
                       default_config=None, config_dir=gs.CONFIG_DIR)
    out = tmp_path / "web"
    server, base = _serve(webapp, config, out)
    try:
        # a cleared init_image overrides the launch config's (which does not exist)
        page = _post(base, ckpt=flow, n_samples=3, cfg=3.0, method="rk4", steps=3, seed=0,
                     init_image="", init_strength=0.5)
        assert "generated 3 samples with rk4" in page, page[-2500:]
        names = sorted(n for n in os.listdir(out) if n.startswith("sample_"))
        assert names == [f"sample_000_{i:03d}.png" for i in range(3)]
        for name in names:
            assert f'src="/files/{name}"' in page
            resp = urllib.request.urlopen(f"{base}/files/{name}", timeout=10)
            assert resp.headers["Content-Type"] == "image/png"
            assert resp.read() == (out / name).read_bytes()
    finally:
        _stop(server)
    direct = tmp_path / "direct"
    cfg = to_dict(config)
    cfg.update(flow_checkpoint=flow, n_samples=3, cfg_strength=3.0, n_steps=3, seed=0,
               method="rk4", output_dir=str(direct), batch_size=3, init_image=None,
               init_strength=0.5)
    res = gs.generate_samples(config_from_dict(cfg))
    assert res["device"] == "cpu" and res["images"].shape == (3, 32, 32, 3)
    for name in names:
        assert (direct / name).read_bytes() == (out / name).read_bytes(), name


def test_use_gradio_serves_the_web_ui(monkeypatch, capsys):
    seen = []
    monkeypatch.setattr(webapp, "launch_webapp", lambda config: seen.append(config))
    assert gs.main(["--config-name", "flowers_vqgan", "+use_gradio=true", "+device=cpu",
                    "+n_steps=7"]) is None
    assert len(seen) == 1 and seen[0]["n_steps"] == 7 and seen[0]["device"] == "cpu"
    assert "serving the first-party stdlib UI" in capsys.readouterr().out
