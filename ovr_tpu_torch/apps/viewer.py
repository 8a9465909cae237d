"""Interactive viewer: live camera + transfer-function editor in a browser
(port of `apps.viewer`).

The capability mirror of the reference's GLFW/ImGui app
(`apps/main_app.cpp:522-603`): a background render thread drives
`api.Renderer` (the AsyncLoop + TransactionalValue pattern,
`ovr/common/vidi_async_loop.h:31-135`, re-expressed as a Python thread with
a queued-setter mailbox), and a stdlib HTTP server serves an HTML front end
with

- mouse camera manipulation (drag = inspect orbit, wheel = dolly, shift-drag
  = pan — `extern/glfwapp/GLFWApp.h:107-209` manipulators),
- a transfer-function editor: draggable alpha control points over a colormap
  strip + named-colormap selector (`extern/tfn/widget.h:34-115`),
- render settings (spp, sampling rate, shading mode, accumulation, sparse
  sampling + focus controls — the ImGui panel, `main_app.cpp:400-478`),
- an fps/variance overlay (`main_app.cpp:495-501`) and a screenshot key
  (`main_app.cpp:320-331`).

Run:  python -m ovr_tpu_torch.apps.viewer SCENE.json [--device cuda|cpu]
          [--port 8000] [--fbsize W H] ...
"""

from __future__ import annotations

import argparse
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ovr_tpu_torch import api
from ovr_tpu_torch.io.colormaps import available_colormaps, create_colormap
from ovr_tpu_torch.io.image import save_image, timestamped_path
from ovr_tpu_torch.utils.timers import FPSCounter


class RenderSession:
    """Background render loop + thread-safe parameter mailbox. A render
    that raises leaves the last good frame published and counts in
    `errors`."""

    def __init__(self, scene, cfg: api.RenderConfig):
        self.renderer = api.Renderer(scene, cfg)
        self._lock = threading.Lock()
        self._pending = []  # queued (setter_name, args) ops
        self._image = None  # the last frame, uint8 rows top down
        self._png = b""  # its PNG, once a client asked for it
        self._frame_id = 0
        self._fps = FPSCounter()
        self._stop = threading.Event()
        self._wake = threading.Event()  # parameter changed: re-render
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self.tf_state = None  # last TF edit, echoed to new clients
        self.errors = 0  # renders that raised

    # -- mailbox (the TransactionalValue pattern) --
    def queue(self, name: str, *args) -> None:
        self.submit([(name, args)])

    def submit(self, ops: list) -> None:
        """Queue (setter_name, args) ops as one transaction: the render
        thread drains them together, so one frame sees all of them."""
        with self._lock:
            self._pending.extend(ops)
        self._wake.set()

    def _drain(self) -> None:
        with self._lock:
            ops, self._pending = self._pending, []
        for name, args in ops:
            getattr(self.renderer, name)(*args)

    # -- render thread --
    def _loop(self) -> None:
        rendered_once = False
        while not self._stop.is_set():
            # idle detection: with nothing queued, no accumulation in
            # progress, and a frame already published, park on the wake
            # event instead of re-rendering an identical frame (the
            # reference's AsyncLoop parks on a condvar the same way,
            # vidi_async_loop.h:47-55)
            if (rendered_once and not self.renderer._accumulating
                    and not self._pending):
                if not self._wake.wait(timeout=0.5):
                    continue
            self._wake.clear()
            try:
                self._drain()
                self.renderer.render()
            except Exception as e:  # keep serving the last good frame
                self.errors += 1
                print(f"[viewer] render error: {e!r}")
                time.sleep(0.25)
                continue
            rendered_once = True
            rgba = self.renderer.mapframe()["rgba"]
            self._publish(rgba)
            self._fps.frame()

    def _publish(self, rgba: np.ndarray) -> None:
        u8 = (np.clip(rgba, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        u8 = np.ascontiguousarray(u8[::-1])  # y-up framebuffer -> rows
        with self._lock:
            self._image, self._png = u8, b""
            self._frame_id += 1

    def start(self) -> None:
        self._thread.start()

    def stop(self, timeout: float = 10.0) -> None:
        """Stop the render thread and wait up to `timeout` s for it."""
        self._stop.set()
        self._wake.set()
        if self._thread.is_alive():
            self._thread.join(timeout)

    @property
    def frame_id(self) -> int:
        """Frames published so far."""
        with self._lock:
            return self._frame_id

    def frame_png(self) -> tuple[bytes, int]:
        """(the last published frame as PNG bytes, or b"" before the
        first, its frame id). Encoded when first asked for, once per
        frame."""
        with self._lock:
            image, png, fid = self._image, self._png, self._frame_id
        if image is None or png:
            return png, fid
        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(image, "RGBA").save(buf, "PNG")
        png = buf.getvalue()
        with self._lock:
            if self._frame_id == fid:
                self._png = png
        return png, fid

    def stats(self) -> dict:
        r = self.renderer
        cam = r._camera
        return {
            "fps": round(self._fps.fps, 2),
            "variance": (None if not np.isfinite(r.variance)
                         else float(r.variance)),
            "frame": self.frame_id,
            "errors": self.errors,
            "size": [r._cfg.width, r._cfg.height],
            "camera": {"from": cam.from_.cpu().tolist(),
                       "at": cam.at.cpu().tolist(),
                       "up": cam.up.cpu().tolist()},
            "tf": self.tf_state,
        }

    def screenshot(self) -> str:
        rgba = self.renderer.mapframe()["rgba"]
        path = timestamped_path("screenshot", ".png")
        save_image(path, rgba)
        return path


def apply_settings(sess: RenderSession, msg: dict) -> None:
    """Translate a client message into Renderer setter calls, queued as
    one transaction."""
    ops = []
    if "camera" in msg:
        c = msg["camera"]
        ops.append(("set_camera", (c["from"], c["at"],
                                   c.get("up", (0, 1, 0)))))
    if "tfn" in msg:
        t = msg["tfn"]
        pts = sorted(t["alphas"], key=lambda p: p[0])  # [[pos, val], ...]
        xs = np.linspace(0.0, 1.0, 256, dtype=np.float32)
        pos = np.asarray([p[0] for p in pts], np.float32)
        val = np.asarray([p[1] for p in pts], np.float32)
        alpha = np.interp(xs, pos, val).astype(np.float32)
        if t.get("colors"):
            # user-edited color control points [[pos, r, g, b], ...]
            # (the reference TF widget's color CPs, extern/tfn/widget.h)
            cps = sorted(t["colors"], key=lambda c: c[0])
            cpos = np.asarray([c[0] for c in cps], np.float32)
            color = np.stack(
                [np.interp(xs, cpos, [c[1 + i] for c in cps])
                 for i in range(3)], -1).astype(np.float32)
        else:
            color = create_colormap(t.get("colormap", "rainbow"), 256)
        vr = sess.renderer.scene.tfn.value_range.cpu()
        ops.append(("set_transfer_function",
                    (color, alpha, (float(vr[0]), float(vr[1])))))
        sess.tf_state = t
    if "spp" in msg:
        ops.append(("set_sample_per_pixel", (int(msg["spp"]),)))
    if "sampling_rate" in msg:
        ops.append(("set_volume_sampling_rate", (float(msg["sampling_rate"]),)))
    if "shading" in msg:
        ops.append(("set_shading", (str(msg["shading"]),)))
    if "accumulation" in msg:
        ops.append(("set_frame_accumulation", (bool(msg["accumulation"]),)))
    if "path_tracing" in msg:
        ops.append(("set_path_tracing", (bool(msg["path_tracing"]),)))
    if "sparse" in msg:
        ops.append(("set_sparse_sampling", (bool(msg["sparse"]),)))
    if "focus" in msg:
        f = msg["focus"]
        ops.append(("set_focus", (tuple(f["center"]), float(f["scale"]),
                                  float(f["base_noise"]))))
    if ops:
        sess.submit(ops)


def make_handler(sess: RenderSession, page: str = None):
    """The HTTP handler class of `sess`, serving `page` (default: PAGE)
    at /."""
    page = PAGE if page is None else page

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.startswith("/frame.png"):
                png, _ = sess.frame_png()
                if not png:
                    self._send(503, b"{}")
                else:
                    self._send(200, png, "image/png")
            elif self.path.startswith("/stats"):
                self._send(200, json.dumps(sess.stats()).encode())
            elif self.path.startswith("/colormaps"):
                self._send(200, json.dumps(available_colormaps()).encode())
            elif self.path.startswith("/colormap?"):
                from urllib.parse import parse_qs, urlparse
                q = parse_qs(urlparse(self.path).query)
                name = q.get("name", ["rainbow"])[0]
                try:
                    tab = create_colormap(name, 32)
                except (KeyError, ValueError):
                    tab = create_colormap("rainbow", 32)
                self._send(200, json.dumps(
                    np.asarray(tab).round(4).tolist()).encode())
            elif self.path.startswith("/screenshot"):
                path = sess.screenshot()
                self._send(200, json.dumps({"saved": path}).encode())
            elif self.path == "/" or self.path.startswith("/index"):
                self._send(200, page.encode(), "text/html; charset=utf-8")
            else:
                self._send(404, b"{}")

        def do_POST(self):
            if self.path.startswith("/set"):
                n = int(self.headers.get("Content-Length", 0))
                msg = json.loads(self.rfile.read(n) or b"{}")
                apply_settings(sess, msg)
                self._send(200, b"{}")
            else:
                self._send(404, b"{}")

    return Handler


PAGE = r"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>ovr_tpu_torch viewer</title><style>
body{background:#181818;color:#ddd;font:13px sans-serif;margin:0;display:flex}
#view{flex:1;display:flex;align-items:center;justify-content:center;height:100vh}
#frame{image-rendering:pixelated;max-width:100%;max-height:100%;cursor:grab}
#panel{width:300px;padding:12px;background:#222;overflow-y:auto;height:100vh;box-sizing:border-box}
#panel h3{margin:10px 0 4px;font-size:13px;color:#9cf}
label{display:block;margin:6px 0 2px}
input[type=range]{width:100%}
select,button{width:100%;margin:2px 0;background:#333;color:#ddd;border:1px solid #555;padding:4px}
#tfcanvas{width:100%;height:142px;background:#111;border:1px solid #444;touch-action:none}
#overlay{position:fixed;left:8px;top:8px;background:#0008;padding:4px 8px;border-radius:4px}
</style></head><body>
<div id="view"><img id="frame"></div>
<div id="overlay">fps: <span id="fps">-</span> | var: <span id="var">-</span></div>
<div id="panel">
  <h3>Transfer function</h3>
  <canvas id="tfcanvas" width="280" height="142"></canvas>
  <input type="color" id="cpcolor" title="selected color control point">
  <select id="colormap"></select>
  <h3>Camera</h3>
  <label>mode (f key): inspect orbit / fly WASDQE</label>
  <select id="cammode"><option>inspect</option><option>fly</option></select>
  <h3>Render</h3>
  <label>spp <span id="sppv">1</span></label>
  <input type="range" id="spp" min="1" max="8" value="1">
  <label>sampling rate <span id="ratev"></span></label>
  <input type="range" id="rate" min="0" max="100" value="50">
  <label>shading</label>
  <select id="shading">
    <option>none</option><option>diffuse</option>
    <option selected>shadow</option><option>ssh</option>
  </select>
  <label><input type="checkbox" id="accum"> frame accumulation</label>
  <label><input type="checkbox" id="pt"> path tracing (GI)</label>
  <label><input type="checkbox" id="sparse"> sparse sampling</label>
  <label>focus scale <span id="focusv">0.2</span></label>
  <input type="range" id="focus" min="2" max="100" value="20">
  <button id="shot">screenshot (s)</button>
</div>
<script>
const img = document.getElementById('frame');
let baseRate = null;
function post(msg){fetch('/set',{method:'POST',body:JSON.stringify(msg)});}
// ---- frame polling ----
let lastFrame = -1;
async function poll(){
  try{
    const s = await (await fetch('/stats')).json();
    document.getElementById('fps').textContent = s.fps;
    document.getElementById('var').textContent = s.variance==null?'-':s.variance.toExponential(2);
    if(s.frame!==lastFrame){lastFrame=s.frame;img.src='/frame.png?'+s.frame;}
    if(cam.r===null && s.camera && camMode==='inspect'){camFromServer(s.camera);}
  }catch(e){}
  setTimeout(poll,100);
}
// ---- camera (inspect + fly manipulators, GLFWApp.h:107-209) ----
const cam={at:[0.5,0.5,0.5],r:null,theta:0,phi:0,up:[0,1,0]};
function camFromServer(c){
  cam.at=c.at;const d=[c.from[0]-c.at[0],c.from[1]-c.at[1],c.from[2]-c.at[2]];
  cam.r=Math.hypot(...d);cam.theta=Math.acos(Math.max(-1,Math.min(1,d[1]/cam.r)));
  cam.phi=Math.atan2(d[2],d[0]);
}
function pushCam(){
  if(cam.r===null)return;
  const st=Math.sin(cam.theta),from=[
    cam.at[0]+cam.r*st*Math.cos(cam.phi),
    cam.at[1]+cam.r*Math.cos(cam.theta),
    cam.at[2]+cam.r*st*Math.sin(cam.phi)];
  post({camera:{from:from,at:cam.at,up:cam.up}});
}
// fly mode: mouse-look + WASDQE motion (the reference's second
// CameraFrameManip, extern/glfwapp/GLFWApp.h:107-209)
let camMode='inspect';
const fly={eye:null,yaw:0,pitch:0,speed:0.05};
function enterFly(){
  if(cam.r===null)return;
  const st=Math.sin(cam.theta);
  fly.eye=[cam.at[0]+cam.r*st*Math.cos(cam.phi),
           cam.at[1]+cam.r*Math.cos(cam.theta),
           cam.at[2]+cam.r*st*Math.sin(cam.phi)];
  const d=[cam.at[0]-fly.eye[0],cam.at[1]-fly.eye[1],cam.at[2]-fly.eye[2]];
  const n=Math.hypot(...d);
  fly.yaw=Math.atan2(d[2],d[0]);fly.pitch=Math.asin(d[1]/n);
  fly.speed=cam.r*0.05;
}
function flyDir(){const cp=Math.cos(fly.pitch);
  return [cp*Math.cos(fly.yaw),Math.sin(fly.pitch),cp*Math.sin(fly.yaw)];}
function pushFly(){const d=flyDir();
  post({camera:{from:fly.eye.slice(),
    at:[fly.eye[0]+d[0],fly.eye[1]+d[1],fly.eye[2]+d[2]],up:[0,1,0]}});}
function setMode(m){
  camMode=m;document.getElementById('cammode').value=m;
  if(m==='fly')enterFly();else cam.r=null; /* resync from server */
}
document.getElementById('cammode').addEventListener('change',
  e=>setMode(e.target.value));
let drag=null;
img.addEventListener('pointerdown',e=>{drag=[e.clientX,e.clientY,e.shiftKey];img.setPointerCapture(e.pointerId);});
img.addEventListener('pointermove',e=>{
  if(!drag)return;
  const dx=e.clientX-drag[0],dy=e.clientY-drag[1];drag=[e.clientX,e.clientY,drag[2]];
  if(camMode==='fly'){
    if(fly.eye===null)return;
    fly.yaw+=dx*0.004;
    fly.pitch=Math.max(-1.5,Math.min(1.5,fly.pitch-dy*0.004));
    pushFly();return;
  }
  if(cam.r===null)return;
  if(drag[2]){ // pan: move the poi in the view plane
    const s=cam.r*0.002;
    const st=Math.sin(cam.theta);
    const fwd=[-st*Math.cos(cam.phi),-Math.cos(cam.theta),-st*Math.sin(cam.phi)];
    const right=[-Math.sin(cam.phi),0,Math.cos(cam.phi)];
    const upv=[fwd[1]*right[2]-fwd[2]*right[1],fwd[2]*right[0]-fwd[0]*right[2],fwd[0]*right[1]-fwd[1]*right[0]];
    for(let i=0;i<3;i++)cam.at[i]+=(-dx*right[i]+dy*upv[i])*s;
  }else{
    cam.phi+=dx*0.01;cam.theta=Math.max(0.05,Math.min(Math.PI-0.05,cam.theta-dy*0.01));
  }
  pushCam();
});
img.addEventListener('pointerup',()=>drag=null);
img.addEventListener('wheel',e=>{e.preventDefault();
  if(camMode==='fly'){fly.speed*=Math.exp(-e.deltaY*0.001);return;}
  if(cam.r===null)return;
  cam.r*=Math.exp(e.deltaY*0.001);pushCam();},{passive:false});
window.addEventListener('keydown',e=>{
  if(e.key==='f'){setMode(camMode==='fly'?'inspect':'fly');return;}
  if(camMode!=='fly'||fly.eye===null)return;
  const d=flyDir();
  const right=[-Math.sin(fly.yaw),0,Math.cos(fly.yaw)];
  const mv={w:d,s:d.map(x=>-x),d:right,a:right.map(x=>-x),
            e:[0,1,0],q:[0,-1,0]}[e.key];
  if(!mv)return;
  for(let i=0;i<3;i++)fly.eye[i]+=mv[i]*fly.speed;
  pushFly();
});
// ---- TF editor (alpha curve + color control points, tfn/widget.h) ----
const tfc=document.getElementById('tfcanvas'),ctx=tfc.getContext('2d');
const picker=document.getElementById('cpcolor');
const STRIP=18, GAP=4;             // color strip at the canvas bottom
const AH=()=>tfc.height-STRIP-GAP; // alpha area height
let alphas=[[0,0],[0.25,0.1],[0.75,0.6],[1,0.9]];
let cmap='rainbow';
let colors=null;     // [[pos,r,g,b],...] custom CPs; null = named map
let stripRGB=null;   // named map samples [[r,g,b]...] for drawing/seeding
function lerpColors(x){
  const cs=colors;let i=1;while(i<cs.length-1&&cs[i][0]<x)i++;
  const a=cs[i-1],b=cs[i],f=(x-a[0])/Math.max(b[0]-a[0],1e-6);
  const t=Math.max(0,Math.min(1,f));
  return [a[1]+(b[1]-a[1])*t,a[2]+(b[2]-a[2])*t,a[3]+(b[3]-a[3])*t];
}
function stripColor(x){
  if(colors)return lerpColors(x);
  if(stripRGB){const i=Math.min(stripRGB.length-1,Math.max(0,
    Math.round(x*(stripRGB.length-1))));return stripRGB[i];}
  return [x,0.3,1-x];
}
function drawTF(){
  ctx.clearRect(0,0,tfc.width,tfc.height);
  const ah=AH();
  ctx.strokeStyle='#9cf';ctx.beginPath();
  alphas.forEach((p,i)=>{const x=p[0]*tfc.width,y=(1-p[1])*ah;
    i?ctx.lineTo(x,y):ctx.moveTo(x,y);});
  ctx.stroke();
  ctx.fillStyle='#fc6';
  alphas.forEach(p=>{ctx.beginPath();
    ctx.arc(p[0]*tfc.width,(1-p[1])*ah,4,0,7);ctx.fill();});
  // color strip
  for(let px=0;px<tfc.width;px++){
    const c=stripColor(px/(tfc.width-1));
    ctx.fillStyle=`rgb(${c[0]*255|0},${c[1]*255|0},${c[2]*255|0})`;
    ctx.fillRect(px,ah+GAP,1,STRIP);
  }
  if(colors)colors.forEach(c=>{ // CP markers: triangles on the strip
    const x=c[0]*tfc.width,y=ah+GAP;
    ctx.fillStyle='#fff';ctx.beginPath();
    ctx.moveTo(x,y);ctx.lineTo(x-5,y+9);ctx.lineTo(x+5,y+9);ctx.fill();
    ctx.strokeStyle='#000';ctx.stroke();
  });
}
function seedColors(){ // start editing: sample the named map into 5 CPs
  colors=[];for(let i=0;i<5;i++){const x=i/4;
    const c=stripColor(x);colors.push([x,c[0],c[1],c[2]]);}
}
let tfDrag=-1,cpDrag=-1,cpSel=-1;
function tfPos(e){const r=tfc.getBoundingClientRect();
  return [(e.clientX-r.left)/r.width,(e.clientY-r.top)/r.height*tfc.height];}
tfc.addEventListener('pointerdown',e=>{
  const [x,py]=tfPos(e);const ah=AH();
  if(py>ah){ // strip: color CP interactions
    const hit=colors?colors.findIndex(c=>Math.abs(c[0]-x)<0.04):-1;
    if(e.altKey&&hit>0&&hit<colors.length-1){colors.splice(hit,1);sendTF();}
    else if(hit>=0){cpDrag=cpSel=hit;
      const c=colors[hit];picker.value='#'+[c[1],c[2],c[3]].map(
        v=>(v*255|0).toString(16).padStart(2,'0')).join('');}
    else if(e.detail===2){if(!colors)seedColors();
      const c=stripColor(x);colors.push([x,c[0],c[1],c[2]]);
      colors.sort((a,b)=>a[0]-b[0]);sendTF();}
  }else{
    const y=1-py/ah;
    tfDrag=alphas.findIndex(p=>Math.abs(p[0]-x)<0.05&&Math.abs(p[1]-y)<0.12);
    if(e.detail===2&&tfDrag<0){alphas.push([x,Math.max(0,Math.min(1,y))]);
      alphas.sort((a,b)=>a[0]-b[0]);sendTF();}
  }
  tfc.setPointerCapture(e.pointerId);
});
tfc.addEventListener('pointermove',e=>{
  const [x,py]=tfPos(e);const ah=AH();
  if(cpDrag>0&&cpDrag<colors.length-1){
    const lo=colors[cpDrag-1][0],hi=colors[cpDrag+1][0];
    colors[cpDrag][0]=Math.max(lo,Math.min(hi,x));drawTF();return;}
  if(tfDrag<0)return;const y=1-py/ah;
  const lo=tfDrag>0?alphas[tfDrag-1][0]:0,hi=tfDrag<alphas.length-1?alphas[tfDrag+1][0]:1;
  if(tfDrag>0&&tfDrag<alphas.length-1)alphas[tfDrag][0]=Math.max(lo,Math.min(hi,x));
  alphas[tfDrag][1]=Math.max(0,Math.min(1,y));
  drawTF();
});
tfc.addEventListener('pointerup',()=>{
  if(tfDrag>=0){tfDrag=-1;sendTF();}
  if(cpDrag>=0){cpDrag=-1;sendTF();}
});
picker.addEventListener('input',()=>{
  if(cpSel<0||!colors)return;
  const v=picker.value;
  colors[cpSel][1]=parseInt(v.substr(1,2),16)/255;
  colors[cpSel][2]=parseInt(v.substr(3,2),16)/255;
  colors[cpSel][3]=parseInt(v.substr(5,2),16)/255;
  sendTF();
});
function sendTF(){drawTF();post({tfn:{alphas:alphas,colormap:cmap,colors:colors}});}
function loadStrip(){fetch('/colormap?name='+encodeURIComponent(cmap))
  .then(r=>r.json()).then(t=>{stripRGB=t;drawTF();});}
// ---- controls ----
fetch('/colormaps').then(r=>r.json()).then(names=>{
  const sel=document.getElementById('colormap');
  names.forEach(n=>{const o=document.createElement('option');o.textContent=n;sel.append(o);});
  sel.value='rainbow';
  sel.onchange=()=>{cmap=sel.value;colors=null;cpSel=-1;loadStrip();sendTF();};
  loadStrip();
});
document.getElementById('spp').oninput=e=>{
  document.getElementById('sppv').textContent=e.target.value;
  post({spp:+e.target.value});};
document.getElementById('rate').oninput=e=>{
  if(baseRate===null)return;
  const r=baseRate*Math.pow(2,(e.target.value-50)/25);
  document.getElementById('ratev').textContent=r.toFixed(1);
  post({sampling_rate:r});};
document.getElementById('shading').onchange=e=>post({shading:e.target.value});
document.getElementById('accum').onchange=e=>post({accumulation:e.target.checked});
document.getElementById('pt').onchange=e=>post({path_tracing:e.target.checked});
document.getElementById('sparse').onchange=e=>post({sparse:e.target.checked});
document.getElementById('focus').oninput=e=>{
  const s=e.target.value/100;
  document.getElementById('focusv').textContent=s.toFixed(2);
  post({focus:{center:[0.5,0.5],scale:s,base_noise:0.05}});};
document.getElementById('shot').onclick=()=>fetch('/screenshot');
window.addEventListener('keydown',e=>{
  if(e.key==='s'&&camMode!=='fly')fetch('/screenshot');});
fetch('/stats').then(r=>r.json()).then(s=>{});
drawTF();poll();
</script></body></html>
"""


def main(argv=None) -> None:
    p = argparse.ArgumentParser("Interactive viewer")
    p.add_argument("scene")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (cuda, cuda:N or cpu)")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--fbsize", type=int, nargs=2, default=[512, 512])
    p.add_argument("--sampling-rate", type=float, default=None)
    p.add_argument("--shading", default="shadow",
                   choices=["none", "diffuse", "shadow", "ssh"])
    p.add_argument("--spp", type=int, default=1)
    p.add_argument("--use-macrocells", action="store_true")
    args = p.parse_args(argv)

    from ovr_tpu_torch.io.vidi3d import create_scene

    scene = create_scene(args.scene, device=args.device)
    rate = args.sampling_rate or float(scene.volume_sampling_rate.cpu())
    cfg = api.RenderConfig(
        width=args.fbsize[0], height=args.fbsize[1], spp=args.spp,
        sampling_rate=rate, shading=args.shading, fast_math=True,
        use_macrocells=args.use_macrocells, method="auto")
    sess = RenderSession(scene, cfg)
    sess.start()

    # expose the scene's sampling rate so the slider scales around it
    page = PAGE.replace("let baseRate = null;", f"let baseRate = {rate};")
    server = ThreadingHTTPServer(("0.0.0.0", args.port),
                                 make_handler(sess, page))
    print(f"[viewer] http://localhost:{args.port}  (scene: {args.scene})")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        sess.stop()


if __name__ == "__main__":
    main()
