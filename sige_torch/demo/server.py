"""Zero-dependency web UI for interactive editing — the port of
``sige_tpu.demo.server``.

The reference ships a PyQt5 paint app (reference: diffusion_demo/start.py,
ui/); on a headless GPU host a browser canvas is the natural equivalent.

  python -m sige_torch.demo.server --tiny --resolution 32 --sample_steps 4
  python -m sige_torch.demo.server --image base.png   # church256 demo

It runs on the GPU; ``--device cpu`` runs it on the CPU. Endpoints:
POST /reset {session} -> base conversion; POST /generate {image: PNG
dataURL, session} -> sparse edit preview; POST /apply {image, session} ->
commit the edit (sparse_update); GET /stamps -> the stamp PNGs. Images
travel as PNG data URLs through the port's own codec
(:mod:`sige_torch.demo.png`); the page draws at R x R pixels, and an
edit of another size is resized to R x R with PIL's bicubic filter (as
``sige_tpu``'s server does); a payload that is not an image answers 400.
"""

from __future__ import annotations

import argparse
import base64
import json
import time
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np

from ..models.ddpm import DDPMUNetConfig
from .. import data
from ..nn.engine import resolve_device
from ..utils.checkpoint import restore
from ..utils.convert import convert_ddpm_fused_unet
from .canvas import STAMP_NAMES, make_stamp
from .png import decode_png, encode_png
from .runner import DemoRunner, MultiSessionDemoRunner

PAGE = """<!DOCTYPE html>
<html><head><title>sige-torch demo</title><style>
body{font-family:sans-serif;margin:20px} canvas{border:1px solid #888;
image-rendering:pixelated;width:512px;height:512px} .row{display:flex;gap:16px}
button{margin:4px;padding:6px 14px}</style></head><body>
<h2>sige-torch interactive editing <span id="sess"></span></h2>
<div class="row">
 <div><h4>paint</h4><canvas id="edit"></canvas></div>
 <div><h4>generated</h4><canvas id="out"></canvas></div>
</div>
<div>
 tool <select id="tool">
  <option value="brush">brush</option>
  <option value="eraser">eraser</option>
  <option value="fill">fill</option>
  <option value="stamp">stamp</option>
 </select>
 stamp <select id="stamp"></select>
 <input type="file" id="stampfile" accept="image/*" style="width:140px">
 color <input type="color" id="color" value="#b05030">
 size <input type="range" id="size" min="2" max="40" value="12">
 <button onclick="undo()">undo</button>
 <button onclick="send('/generate')">generate</button>
 <button onclick="send('/apply')">apply</button>
 <button onclick="reset()">reset base</button>
 <span id="status"></span>
</div>
<script>
const R = %RES%;
// multi-user: /?session=N addresses one of the server's sessions
// (each has its own base image, caches and edit plan)
const SESSION = parseInt(new URLSearchParams(location.search)
                         .get('session') || '0', 10);
if (SESSION) document.getElementById('sess').textContent =
    '(session ' + SESSION + ')';
const ec = document.getElementById('edit'), oc = document.getElementById('out');
ec.width = ec.height = oc.width = oc.height = R;
const ectx = ec.getContext('2d'), octx = oc.getContext('2d');
let drawing = false;
let baseImg = null;  // kept for the eraser (restores base pixels)
const undoStack = [];  // bounded snapshot history (server twin: demo/canvas.py UndoStack)
function snapshot(){
  undoStack.push(ectx.getImageData(0, 0, R, R));
  if (undoStack.length > 20) undoStack.shift();
}
function undo(){
  const im = undoStack.pop();
  if (im) ectx.putImageData(im, 0, 0);
}
window.onkeydown = e => {
  if ((e.ctrlKey || e.metaKey) && e.key === 'z') { e.preventDefault(); undo(); }
};
const stamps = {};  // name -> Image, filled from /stamps + the file input
document.getElementById('stampfile').onchange = e => {
  const f = e.target.files[0];
  if (!f) return;
  const img = new Image();
  img.onload = () => {
    stamps[f.name] = img;
    const o = document.createElement('option');
    o.value = o.textContent = f.name;
    document.getElementById('stamp').appendChild(o);
    document.getElementById('stamp').value = f.name;
  };
  img.src = URL.createObjectURL(f);
};
function stampAt(e){
  // centered placement, like the reference's drawPixmap stamp
  const img = stamps[document.getElementById('stamp').value];
  if (!img) return;
  const [x, y] = pos(e);
  const s = document.getElementById('size').value * R / 512 * 6;
  snapshot();
  ectx.drawImage(img, x - s/2, y - s/2, s, s);
}
ec.onmousedown = e => {
  const t = document.getElementById('tool').value;
  if (t === 'fill') { snapshot(); fill(e); return; }
  if (t === 'stamp') { stampAt(e); return; }
  snapshot();
  drawing = true; draw(e);
};
ec.onmousemove = e => {if (drawing) draw(e);};
window.onmouseup = () => drawing = false;
function pos(e){
  const r = ec.getBoundingClientRect();
  return [(e.clientX - r.left) * R / r.width,
          (e.clientY - r.top) * R / r.height];
}
function draw(e){
  const [x, y] = pos(e);
  const s = document.getElementById('size').value * R / 512;
  if (document.getElementById('tool').value === 'eraser' && baseImg){
    // restore the base image under a square around the cursor
    const x0 = Math.max(0, x - s), y0 = Math.max(0, y - s);
    ectx.drawImage(baseImg, x0, y0, 2*s, 2*s, x0, y0, 2*s, 2*s);
    return;
  }
  ectx.fillStyle = document.getElementById('color').value;
  ectx.beginPath(); ectx.arc(x, y, s, 0, 7); ectx.fill();
}
function fill(e){
  // flood fill from the click point over similar-colored pixels
  const [fx, fy] = pos(e).map(Math.floor);
  const img = ectx.getImageData(0, 0, R, R), d = img.data;
  const c = document.getElementById('color').value;
  const nr = parseInt(c.slice(1,3),16), ng = parseInt(c.slice(3,5),16),
        nb = parseInt(c.slice(5,7),16);
  const i0 = 4*(fy*R + fx);
  const sr = d[i0], sg = d[i0+1], sb = d[i0+2], TOL = 32;
  if (Math.abs(sr-nr)+Math.abs(sg-ng)+Math.abs(sb-nb) < 3) return;
  const stack = [[fx, fy]], seen = new Uint8Array(R*R);
  while (stack.length){
    const [x, y] = stack.pop();
    if (x < 0 || y < 0 || x >= R || y >= R || seen[y*R+x]) continue;
    const i = 4*(y*R + x);
    if (Math.abs(d[i]-sr)+Math.abs(d[i+1]-sg)+Math.abs(d[i+2]-sb) > TOL)
      continue;
    seen[y*R+x] = 1;
    d[i] = nr; d[i+1] = ng; d[i+2] = nb; d[i+3] = 255;
    stack.push([x+1,y],[x-1,y],[x,y+1],[x,y-1]);
  }
  ectx.putImageData(img, 0, 0);
}
async function post(path, body){
  document.getElementById('status').textContent = '...';
  const res = await fetch(path, {method:'POST', body: JSON.stringify(body)});
  const js = await res.json();
  document.getElementById('status').textContent =
      js.error || (js.ms ? js.ms.toFixed(0)+' ms' : '');
  return js;
}
async function send(path){
  const js = await post(path, {image: ec.toDataURL(), session: SESSION});
  const img = new Image();
  img.onload = () => octx.drawImage(img, 0, 0);
  img.src = js.image;
  if (path === '/apply') { /* edited becomes the new baseline */ }
}
async function reset(){
  const js = await post('/reset', {session: SESSION});
  const img = new Image();
  img.onload = () => {
    ectx.drawImage(img, 0, 0); octx.drawImage(img, 0, 0); baseImg = img;
  };
  img.src = js.base;
  undoStack.length = 0;
}
async function loadStamps(){
  const res = await fetch('/stamps');
  const js = await res.json();
  const sel = document.getElementById('stamp');
  for (const [name, url] of Object.entries(js)){
    const img = new Image();
    img.src = url;
    stamps[name] = img;
    const o = document.createElement('option');
    o.value = o.textContent = name;
    sel.appendChild(o);
  }
}
loadStamps();
reset();
</script></body></html>"""


def to_uint8(arr: np.ndarray) -> np.ndarray:
    """The bytes a [0, 1] image travels as (``sige_tpu``'s conversion)."""
    return (np.clip(arr, 0, 1) * 255).astype(np.uint8)


def png_to_array(data_url: str, resolution: int) -> np.ndarray:
    """[R, R, 3] float32 in [0, 1] from a PNG data URL, read as PIL's
    ``convert("RGB")`` reads it; an image of another size is resized to
    R x R with PIL's bicubic filter, as ``sige_tpu``'s server does."""
    img = decode_png(base64.b64decode(data_url.split(",", 1)[1]))[..., :3]
    if img.shape[:2] != (resolution, resolution):
        img = data.resize_bicubic(img, (resolution, resolution))
    return img.astype(np.float32) / 255.0


def array_to_data_url(arr: np.ndarray, alpha: np.ndarray = None) -> str:
    """A PNG data URL of a [0, 1] image, with an optional alpha plane."""
    rgb = to_uint8(arr)
    if alpha is not None:
        rgb = np.concatenate([rgb, to_uint8(alpha)[..., None]], axis=-1)
    return ("data:image/png;base64,"
            + base64.b64encode(encode_png(rgb)).decode())


def make_handler(runner, base_image: np.ndarray, resolution: int,
                 sessions: int = 1):
    """The request handler over a :class:`~.runner.DemoRunner` (or, with
    ``sessions`` > 1, a :class:`~.runner.MultiSessionDemoRunner`). Every
    POST answers ``ms``, the server-side milliseconds of the request."""
    multi = sessions > 1

    class Handler(BaseHTTPRequestHandler):
        def _send(self, obj, code=200, ctype="application/json"):
            body = obj if isinstance(obj, bytes) else json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/stamps":
                stamps = {name: make_stamp(name) for name in STAMP_NAMES}
                self._send({name: array_to_data_url(s[..., :3],
                                                    alpha=s[..., 3])
                            for name, s in stamps.items()})
                return
            self._send(PAGE.replace("%RES%", str(resolution)).encode(),
                       ctype="text/html")

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(n) or b"{}")
            t0 = time.perf_counter()
            try:
                sid = int(payload.get("session") or 0)
            except (TypeError, ValueError):
                sid = -1
            if not 0 <= sid < sessions:
                self._send({"error": f"session {payload.get('session')!r} "
                                     f"out of range (0..{sessions - 1})"},
                           code=400)
                return
            if self.path == "/reset":
                out = (runner.reset_base_image(sid, base_image) if multi
                       else runner.reset_base_image(base_image))
                self._send({"base": array_to_data_url(out),
                            "ms": (time.perf_counter() - t0) * 1e3})
                return
            try:
                edited = png_to_array(payload["image"], resolution)
            except (KeyError, IndexError, AttributeError, ValueError) as e:
                self._send({"error": f"bad image: {e!r}"}, code=400)
                return
            upd = self.path == "/apply"
            out = (runner.generate(sid, edited, sparse_update=upd) if multi
                   else runner.generate(edited, sparse_update=upd))
            self._send({"image": array_to_data_url(out),
                        "ms": (time.perf_counter() - t0) * 1e3})

        def log_message(self, *a):
            pass

    return Handler


def load_image(path: str, resolution: int) -> np.ndarray:
    """[R, R, 3] float32 in [0, 1] from a PNG (8-bit RGB or RGBA) or a
    ``.npy`` array (uint8, or float in [0, 1]); an image of another size
    is resized to R x R bicubically, as PIL does
    (:func:`sige_torch.data.load_image`)."""
    R = resolution
    if not path.endswith(".npy"):
        return data.load_image(path, size=(R, R))
    img = np.load(path)
    if img.shape[:2] != (R, R):
        return data.resize_bicubic(to_uint8(
            img / 255.0 if img.dtype == np.uint8 else img)[..., :3],
            (R, R)).astype(np.float32) / 255.0
    img = img / 255.0 if img.dtype == np.uint8 else img
    return np.asarray(img[..., :3], np.float32)


def build(args):
    """(runner, base image) for parsed flags."""
    device = resolve_device(args.device)
    R = args.resolution
    if args.tiny:
        cfg = DDPMUNetConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1,
                             attn_resolutions=(8,), resolution=R,
                             sparse_resolution_threshold=R)
    else:
        cfg = DDPMUNetConfig(resolution=R)
    params = None
    if args.restore_from:  # a fused-UNet .pth or a native directory
        params = restore(args.restore_from, lambda sd: convert_ddpm_fused_unet(
            sd, cfg.ch_mult, cfg.num_res_blocks, cfg.attn_resolutions,
            cfg.resolution), device)
    kw = dict(sample_steps=args.sample_steps, params=params,
              bucket_min=1 if args.tiny else 8, sampler_type=args.sampler,
              device=device)
    runner = (MultiSessionDemoRunner(args.sessions, cfg, **kw)
              if args.sessions > 1 else DemoRunner(cfg, **kw))
    if args.image:
        base = load_image(args.image, R)
    else:
        base = np.random.default_rng(0).random((R, R, 3)).astype(np.float32)
    return runner, base


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--image", type=str, default=None,
                   help="base image: a PNG or .npy, resized to R x R")
    p.add_argument("--resolution", type=int, default=256)
    p.add_argument("--sample_steps", type=int, default=25)
    p.add_argument("--sampler", choices=("ddim", "dpm_solver"),
                   default="ddim",
                   help="dpm_solver is the reference demo's default")
    p.add_argument("--tiny", action="store_true",
                   help="tiny random-weight model for smoke testing")
    p.add_argument("--restore_from", type=str, default=None,
                   help="a reference fused-UNet .pth, or a native "
                        "checkpoint dir written by --save_converted")
    p.add_argument("--sessions", type=int, default=1,
                   help="concurrent editing sessions (open /?session=N "
                        "per user)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    runner, base = build(args)
    server = HTTPServer(("0.0.0.0", args.port),
                        make_handler(runner, base, args.resolution,
                                     sessions=args.sessions))
    print(f"sige-torch demo on http://localhost:{args.port}", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
