"""Interactive web viewer: orbit/pan/zoom over HTTP (the H17 equivalent).

The reference's inspection surface is a 4.1k-line ImGui/Vulkan app
(gaussian_splatting_ui.cpp). Here it is a render SERVER: the card renders
frames on demand and a minimal browser page provides the interactivity —
drag to orbit, wheel to zoom, keys for pipeline/SH/display modes. Frames
stream as PNG over plain ``http.server`` (stdlib only; Pillow encodes when
present, else a stdlib PNG writer does).

    python -m vk_gaussian_splatting_tpu_torch.viewer_web scene.ply --port 8000
    # open http://localhost:8000

Query protocol (also usable headless, e.g. curl):
    /frame.png?az=0.5&el=0.2&r=6&pipeline=1&sh=3&mode=rgb|depth|trans
Pipeline ids follow the reference (shaderio.h:61-66): 1 = 3DGS raster,
2 = 3DGRT, 4 = 3DGUT.
"""

from __future__ import annotations

import argparse
import io
import json
import sys
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

_PAGE = """<!doctype html>
<html><head><title>vkgs viewer</title><style>
 body { margin:0; background:#111; color:#ddd; font:13px monospace; }
 #hud { position:fixed; top:8px; left:8px; background:#000a; padding:6px; }
 img { display:block; margin:auto; image-rendering:pixelated; }
</style></head><body>
<div id="hud">drag: orbit &middot; wheel: zoom &middot; keys:
 [1] 3DGS [2] 3DGRT [4] 3DGUT &middot; [d]epth [t]ransmittance [c]olor
 <span id="stat"></span></div>
<img id="v" width="960">
<script>
let az=0.0, el=0.25, r=%RADIUS%, pipe=1, mode='rgb', busy=false, dirty=true;
const img=document.getElementById('v'), stat=document.getElementById('stat');
function refresh(){
  if(busy){dirty=true;return;} busy=true; dirty=false;
  const t0=performance.now();
  const u=`/frame.png?az=${az}&el=${el}&r=${r}&pipeline=${pipe}&mode=${mode}`;
  const i=new Image();
  i.onload=()=>{img.src=i.src; busy=false;
    stat.textContent=` | ${pipe==1?'3DGS':pipe==2?'3DGRT':'3DGUT'} ${mode} `+
      `${(performance.now()-t0).toFixed(0)} ms`;
    if(dirty)refresh();};
  i.src=u;}
let drag=null;
img.onmousedown=e=>{drag=[e.clientX,e.clientY];e.preventDefault();};
window.onmouseup=()=>drag=null;
window.onmousemove=e=>{if(!drag)return;
  az+=(e.clientX-drag[0])*0.01; el+=(e.clientY-drag[1])*0.01;
  el=Math.max(-1.4,Math.min(1.4,el)); drag=[e.clientX,e.clientY];refresh();};
window.onwheel=e=>{r*=Math.exp(e.deltaY*0.001);refresh();};
window.onkeydown=e=>{
  if(e.key=='1')pipe=1; else if(e.key=='2')pipe=2; else if(e.key=='4')pipe=4;
  else if(e.key=='d')mode='depth'; else if(e.key=='t')mode='trans';
  else if(e.key=='c')mode='rgb'; else return; refresh();};
refresh();
</script></body></html>"""


class RenderSession:
    """Holds the prepared scene; renders query-described frames on its
    device (the prepared splats'), one at a time."""

    def __init__(self, prepared, center, radius, width=960, height=544,
                 max_pairs=1 << 21):
        self.prepared = prepared
        self.center = np.asarray(center, np.float32)
        self.radius = float(radius)
        self.width, self.height = width, height
        self.max_pairs = max_pairs
        self.lock = threading.Lock()  # one render on the card at a time

    def _cfg(self, pipeline: int, sh: int):
        from vk_gaussian_splatting_tpu_torch.config import Pipeline, RenderConfig
        return RenderConfig(width=self.width, height=self.height,
                            sh_degree=sh, pipeline=Pipeline(pipeline))

    def render(self, az, el, r, pipeline=1, sh=3, mode="rgb"):
        """(H, W, 3) float image in [0, 1] (numpy): the colour frame, the
        picked depth normalised over the covered pixels (near bright), or
        the transmittance."""
        from vk_gaussian_splatting_tpu_torch.render.pipelines import (
            render_3dgrt,
            render_3dgs,
            render_3dgut,
        )
        from vk_gaussian_splatting_tpu_torch.viewer import orbit_camera

        cam = orbit_camera(self.center, r, az, el, self.width, self.height,
                           device=self.prepared.means.device)
        cfg = self._cfg(int(pipeline), int(sh))
        fn = {2: render_3dgrt, 4: render_3dgut}.get(int(pipeline),
                                                    render_3dgs)
        with self.lock:
            out = fn(self.prepared, cam, cfg, max_pairs=self.max_pairs)
            if mode == "depth":
                d = out.depth.cpu().numpy()
                live = d > 0
                lo = d[live].min() if live.any() else 0.0
                hi = d[live].max() if live.any() else 1.0
                norm = np.where(live, (d - lo) / max(hi - lo, 1e-6), 1.0)
                img = np.repeat((1.0 - norm)[..., None], 3, axis=-1)
            elif mode == "trans":
                img = np.repeat(out.transmittance.cpu().numpy()[..., None],
                                3, axis=-1)
            else:
                img = out.image.cpu().numpy()
        return np.clip(img, 0.0, 1.0)


def encode_png(img01: np.ndarray) -> bytes:
    """PNG-encode an (H, W, 3) float image in [0, 1] as 8-bit RGB (values
    truncated by ``(img * 255).astype(uint8)``): by Pillow when present,
    else by a stdlib writer (zlib, no filters)."""
    img8 = (img01 * 255).astype(np.uint8)
    try:
        from PIL import Image
    except ImportError:
        import struct
        import zlib
        h, w = img8.shape[:2]
        raw = b"".join(b"\x00" + img8[y].tobytes() for y in range(h))

        def chunk(tag, data):
            c = struct.pack(">I", len(data)) + tag + data
            return c + struct.pack(">I", zlib.crc32(tag + data))

        return (b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2,
                                             0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 1))
                + chunk(b"IEND", b""))
    buf = io.BytesIO()
    Image.fromarray(img8).save(buf, format="PNG")
    return buf.getvalue()


def make_handler(session: RenderSession):
    """The request handler class over ``session`` (its ``session``
    attribute)."""
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, ctype, body):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 — http.server API
            url = urllib.parse.urlparse(self.path)
            q = dict(urllib.parse.parse_qsl(url.query))
            if url.path == "/":
                page = _PAGE.replace("%RADIUS%",
                                     f"{session.radius * 2.2:.3f}")
                self._send(200, "text/html", page.encode())
            elif url.path == "/frame.png":
                try:
                    img = session.render(
                        az=float(q.get("az", 0)), el=float(q.get("el", 0.2)),
                        r=float(q.get("r", session.radius * 2.2)),
                        pipeline=int(q.get("pipeline", 1)),
                        sh=int(q.get("sh", 3)), mode=q.get("mode", "rgb"))
                    self._send(200, "image/png", encode_png(img))
                except Exception as e:  # noqa: BLE001 — report to client
                    self._send(500, "application/json",
                               json.dumps({"error": str(e)}).encode())
            else:
                self._send(404, "text/plain", b"not found")

    Handler.session = session
    return Handler


def serve(prepared, center, radius, port=8000, host="0.0.0.0", **kw):
    """The viewer's HTTP server on (host, port) (port 0: any free port,
    ``server_address`` says which); ``kw`` goes to RenderSession."""
    session = RenderSession(prepared, center, radius, **kw)
    httpd = ThreadingHTTPServer((host, port), make_handler(session))
    return httpd  # caller runs serve_forever()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("scene", help=".ply/.spz/.splat scene file")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--host", default="0.0.0.0", help="address to bind")
    ap.add_argument("--size", type=int, nargs=2, default=(960, 544))
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from vk_gaussian_splatting_tpu_torch.io import load_scene
    splats = load_scene(args.scene, device=args.device)
    prepared = splats.prepare()
    means = splats.means.cpu().numpy()
    center = means.mean(axis=0)
    radius = float(np.linalg.norm(means - center, axis=1).mean())
    httpd = serve(prepared, center, radius, port=args.port, host=args.host,
                  width=args.size[0], height=args.size[1])
    print(f"viewer: http://localhost:{httpd.server_address[1]}/  "
          f"({means.shape[0]} splats)", flush=True)
    httpd.serve_forever()


if __name__ == "__main__":
    sys.exit(main())
