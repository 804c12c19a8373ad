"""The sampler's web UI on the Python standard library (``http.server``),
the port's twin of ``flocoder_tpu/ui/webapp.py``.

A form (checkpoint, samples, CFG strength, method, steps, seed, init image
and strength) whose POST runs the port's ``generate_samples`` with those
settings, one generation at a time, then shows the samples as a gallery
with links to any ``.mid`` files and players for any ``.wav`` previews.
The generation runs on the config's device (``+device``): the card unless
the caller asks for the CPU. A generation that raises is reported on the
page as ``ERROR:`` and its traceback.

Usage: ``python -m flocoder_torch.generate_samples --config-name <recipe>
+use_gradio=true`` (the flag keeps the recipes' name; the port serves this
UI whether or not gradio is installed), then open the printed address.
"""
from __future__ import annotations

import glob
import html
import json
import os
import shutil
import threading
import traceback
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..config import config_from_dict, ldcfg, to_dict

__all__ = ["create_app", "launch_webapp", "wavs_from_mids"]

_PAGE = """<!doctype html>
<html><head><title>flocoder-tpu sampler</title><style>
body {{ font-family: sans-serif; margin: 2rem; max-width: 70rem; }}
fieldset {{ border: 1px solid #999; margin-bottom: 1rem; }}
label {{ display: inline-block; min-width: 9rem; margin: .2rem 0; }}
input, select {{ margin-right: 1.2rem; }}
.gallery img {{ width: 128px; height: 128px; image-rendering: pixelated;
               margin: 2px; border: 1px solid #ccc; }}
.err {{ color: #b00; white-space: pre-wrap; }}
.status {{ color: #060; }}
</style></head><body>
<h2>flocoder-tpu — flow-matching sampler</h2>
<form method="post" action="/generate">
<fieldset><legend>generation</legend>
<label>checkpoint</label><input name="ckpt" size="48" value="{ckpt}"><br>
<label>samples</label><input name="n_samples" type="number" value="{n}">
<label>CFG strength</label><input name="cfg" type="number" step="0.5" value="{cfg}"><br>
<label>method</label><select name="method">{methods}</select>
<label>steps</label><input name="steps" type="number" value="{steps}">
<label>seed</label><input name="seed" type="number" value="{seed}"><br>
<label>init image (path)</label><input name="init_image" size="48" value="{init_image}">
<label>init strength</label><input name="init_strength" type="number"
 step="0.1" min="0" max="1" value="{init_strength}"><br>
<button type="submit">Generate</button>
</fieldset></form>
{body}
</body></html>"""


def _gallery_html(out_dir: str, msg: str = "") -> str:
    pngs = sorted(glob.glob(os.path.join(out_dir, "sample_*.png")))
    mids = sorted(glob.glob(os.path.join(out_dir, "*.mid")))
    wavs = sorted(glob.glob(os.path.join(out_dir, "*.wav")))
    parts = []
    if msg:
        parts.append(f'<p class="status">{html.escape(msg)}</p>')
    if pngs:
        imgs = "".join(
            f'<a href="/files/{os.path.basename(p)}">'
            f'<img src="/files/{os.path.basename(p)}"></a>' for p in pngs)
        parts.append(f'<div class="gallery">{imgs}</div>')
    if mids:
        links = " ".join(f'<a href="/files/{os.path.basename(m)}">'
                         f'{os.path.basename(m)}</a>' for m in mids)
        parts.append(f"<p>MIDI: {links}</p>")
    for w in wavs:
        parts.append(f'<audio controls src="/files/{os.path.basename(w)}">'
                     "</audio>")
    return "\n".join(parts)


METHODS = ("rk4", "heun", "midpoint", "ab4", "euler", "rk45", "sde", "meanflow")


def create_app(config, out_dir: str = "samples_web") -> ThreadingHTTPServer:
    """The ``ThreadingHTTPServer`` (on 127.0.0.1, an ephemeral port) serving
    the sampler UI. A POST runs ``generate_samples`` into ``out_dir``, one
    generation at a time under a lock."""
    state = {"msg": "", "last_params": {}}
    lock = threading.Lock()

    defaults = {
        "ckpt": str(config.get("flow_checkpoint", "") or ""),
        "n": int(ldcfg(config, "n_samples", 16)),
        "cfg": float(ldcfg(config, "cfg_strength", 3.0)),
        "steps": int(ldcfg(config, "n_steps", 50)),
        "seed": int(ldcfg(config, "seed", 0)),
        "method": str(ldcfg(config, "method", "rk4")),
        "init_image": str(config.get("init_image", "") or ""),
        "init_strength": float(config.get("init_strength", 0.5)),
    }

    def render(msg=""):
        p = {**defaults, **state["last_params"]}
        methods = "".join(
            f'<option value="{m}"{" selected" if m == p["method"] else ""}>'
            f"{m}</option>" for m in METHODS)
        return _PAGE.format(ckpt=html.escape(str(p["ckpt"])), n=p["n"],
                            cfg=p["cfg"], steps=p["steps"], seed=p["seed"],
                            methods=methods,
                            init_image=html.escape(str(p["init_image"])),
                            init_strength=p["init_strength"],
                            body=_gallery_html(out_dir, msg))

    def run_generation(params: dict) -> str:
        from ..generate_samples import generate_samples
        cfg = to_dict(config) if config else {}
        cfg.update({
            "flow_checkpoint": params["ckpt"], "n_samples": params["n"],
            "cfg_strength": params["cfg"], "n_steps": params["steps"],
            "seed": params["seed"], "method": params["method"],
            "output_dir": out_dir, "batch_size": min(params["n"], 64),
        })
        # always assigned: a cleared field overrides the launch config's
        # init_image rather than leaving it active
        cfg["init_image"] = params.get("init_image") or None
        cfg["init_strength"] = params.get("init_strength", 0.5)
        for f in glob.glob(os.path.join(out_dir, "*")):
            os.remove(f)
        generate_samples(config_from_dict(cfg))
        wavs_from_mids(out_dir)
        return f"generated {params['n']} samples with {params['method']}"

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def _send(self, body, code: int = 200,
                  ctype: str = "text/html; charset=utf-8"):
            data = body.encode() if isinstance(body, str) else body
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path.startswith("/files/"):
                name = os.path.basename(urllib.parse.unquote(
                    self.path[len("/files/"):]))
                path = os.path.join(out_dir, name)
                if not os.path.exists(path):
                    return self._send("not found", 404, "text/plain")
                ctype = {"png": "image/png", "mid": "audio/midi",
                         "wav": "audio/wav"}.get(name.rsplit(".", 1)[-1],
                                                 "application/octet-stream")
                with open(path, "rb") as f:
                    return self._send(f.read(), 200, ctype)
            if self.path.startswith("/status"):
                return self._send(json.dumps(state["msg"] or "idle"), 200,
                                  "application/json")
            return self._send(render(state["msg"]))

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            # keep_blank_values: a cleared text field (init_image=) overrides
            # the config's value instead of falling back to it
            form = urllib.parse.parse_qs(self.rfile.read(length).decode(),
                                         keep_blank_values=True)

            def val(k, cast, dflt):
                try:
                    return cast(form.get(k, [dflt])[0])
                except (ValueError, TypeError):
                    return dflt
            params = {"ckpt": val("ckpt", str, defaults["ckpt"]),
                      "n": val("n_samples", int, defaults["n"]),
                      "cfg": val("cfg", float, defaults["cfg"]),
                      "steps": val("steps", int, defaults["steps"]),
                      "seed": val("seed", int, defaults["seed"]),
                      "method": val("method", str, defaults["method"]),
                      "init_image": val("init_image", str,
                                        defaults["init_image"]),
                      "init_strength": val("init_strength", float,
                                           defaults["init_strength"])}
            state["last_params"] = params
            if not lock.acquire(blocking=False):
                return self._send(render("busy — a generation is running"))
            try:
                state["msg"] = run_generation(params)
            except (Exception, SystemExit):     # generate_samples SystemExits
                state["msg"] = "ERROR:\n" + traceback.format_exc()[-2000:]
            finally:
                lock.release()
            return self._send(render(state["msg"]))

    os.makedirs(out_dir, exist_ok=True)
    return ThreadingHTTPServer(("127.0.0.1", 0), Handler)


def wavs_from_mids(out_dir: str) -> None:
    """A WAV preview beside each ``.mid`` file through the ``timidity``
    program where it is installed; nothing where it is not."""
    if shutil.which("timidity") is None:
        return
    import subprocess
    for mid in glob.glob(os.path.join(out_dir, "*.mid")):
        wav = mid.replace(".mid", ".wav")
        if not os.path.exists(wav):
            subprocess.run(["timidity", mid, "-Ow", "-o", wav], check=False,
                           capture_output=True)


def launch_webapp(config, port: int = 7860) -> None:
    """Serves the UI on 127.0.0.1:``port`` (0: an ephemeral port) until
    interrupted."""
    server = create_app(config)
    if port:
        server.server_close()
        server = ThreadingHTTPServer(("127.0.0.1", port), server.RequestHandlerClass)
    print(f"serving sampler UI on http://127.0.0.1:"
          f"{server.server_address[1]}/ (ctrl-c to stop)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
