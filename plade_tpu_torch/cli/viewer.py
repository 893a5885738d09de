"""Interactive result viewer — self-contained WebGL HTML export.

The reference's ResultViewer (code/ResultViewer/main.cpp:37-95) loads the
first pair of a results file into an Easy3D window: target cloud plus the
source cloud transformed by the recorded matrix (normals by the inverse
transpose, main.cpp:84-92).  This framework has no GUI toolkit dependency,
so the interactive equivalent is a generated single-file HTML viewer:
point data embedded as base64 Float32 buffers, rendering and orbit/pan/
zoom controls written directly against WebGL1 (no external scripts — the
file works offline, from file://).

Rendering mirrors the reference viewer's presentation: target in blue,
registered source in orange, per-point Lambertian shading from the cloud
normals when present (flat points otherwise), drag = orbit, shift-drag or
right-drag = pan, wheel = zoom, keys 1/2 toggle the clouds.

A copy of ``plade_tpu/cli/viewer.py`` (that package imports JAX when it is
imported) that reads through the port's ``io.ply``; its HTML is pinned to
the original's, byte for byte, by ``tests/test_torch_host_io.py``.
"""
from __future__ import annotations

import base64
import sys

import numpy as np


def _parse_results(result_file: str, index: int = 0):
    """(target_path, source_path, 4x4 T) of the ``index``-th pair in a
    results file (both the single-pair and batch formats; identity-failure
    blocks parse the same way — main.cpp:134-147)."""
    pairs = []
    target = source = None
    rows = []
    with open(result_file) as f:
        for line in f:
            line = line.strip()
            if line.startswith("target:"):
                target = line.split(":", 1)[1].strip()
                rows = []
            elif line.startswith("source:"):
                source = line.split(":", 1)[1].strip()
            elif target and source and line and line[0] in "-0123456789":
                rows.append([float(v) for v in line.split()])
                if len(rows) == 4:
                    pairs.append((target, source,
                                  np.asarray(rows, np.float32)))
                    target = source = None
                    rows = []
    if index >= len(pairs):
        return None
    return pairs[index]


def _subsample(pts, nrm, max_points, seed=0):
    n = pts.shape[0]
    if n <= max_points:
        return pts, nrm
    idx = np.random.default_rng(seed).choice(n, max_points, replace=False)
    return pts[idx], None if nrm is None else nrm[idx]


def _b64(arr: np.ndarray) -> str:
    return base64.b64encode(np.ascontiguousarray(
        arr, dtype=np.float32).tobytes()).decode()


_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>plade-tpu viewer</title>
<style>
 html,body{margin:0;height:100%;overflow:hidden;background:#101318;
  font:13px system-ui,sans-serif;color:#cdd3dc}
 #hud{position:fixed;left:10px;top:8px;user-select:none;line-height:1.5;
  background:#10131880;padding:6px 10px;border-radius:6px}
 .sw{display:inline-block;width:10px;height:10px;border-radius:2px;
  margin-right:5px}
 canvas{display:block;width:100vw;height:100vh}
</style></head><body>
<canvas id="c"></canvas>
<div id="hud"><b>plade-tpu result viewer</b><br>
<span class="sw" style="background:#4f8fe8"></span>target: __TGT_NAME__
(<span id="nt"></span> pts) [key 1]<br>
<span class="sw" style="background:#f09440"></span>source &middot;
registered: __SRC_NAME__ (<span id="ns"></span> pts) [key 2]<br>
drag orbit &middot; shift/right-drag pan &middot; wheel zoom</div>
<script>
"use strict";
const TGT_P="__TGT_P__", TGT_N="__TGT_N__";
const SRC_P="__SRC_P__", SRC_N="__SRC_N__";
function f32(b64){const s=atob(b64);const a=new Uint8Array(s.length);
 for(let i=0;i<s.length;i++)a[i]=s.charCodeAt(i);
 return new Float32Array(a.buffer);}
const tp=f32(TGT_P), tn=TGT_N?f32(TGT_N):null;
const sp=f32(SRC_P), sn=SRC_N?f32(SRC_N):null;
document.getElementById("nt").textContent=(tp.length/3)|0;
document.getElementById("ns").textContent=(sp.length/3)|0;
const cv=document.getElementById("c");
const gl=cv.getContext("webgl",{antialias:true});
const VS=`attribute vec3 p;attribute vec3 n;uniform mat4 mvp;
uniform mat3 rot;uniform float ps;varying float sh;
void main(){gl_Position=mvp*vec4(p,1.0);gl_PointSize=ps;
 vec3 nn=rot*n; float l=length(nn);
 sh=l<0.01?1.0:(0.35+0.65*abs(normalize(nn).z));}`;
const FS=`precision mediump float;uniform vec3 col;varying float sh;
void main(){gl_FragColor=vec4(col*sh,1.0);}`;
function mkShader(t,src){const s=gl.createShader(t);gl.shaderSource(s,src);
 gl.compileShader(s);return s;}
const prog=gl.createProgram();
gl.attachShader(prog,mkShader(gl.VERTEX_SHADER,VS));
gl.attachShader(prog,mkShader(gl.FRAGMENT_SHADER,FS));
gl.linkProgram(prog);gl.useProgram(prog);
const aP=gl.getAttribLocation(prog,"p"),aN=gl.getAttribLocation(prog,"n");
const uMVP=gl.getUniformLocation(prog,"mvp"),
 uROT=gl.getUniformLocation(prog,"rot"),
 uCOL=gl.getUniformLocation(prog,"col"),
 uPS=gl.getUniformLocation(prog,"ps");
function buf(data){const b=gl.createBuffer();
 gl.bindBuffer(gl.ARRAY_BUFFER,b);
 gl.bufferData(gl.ARRAY_BUFFER,data,gl.STATIC_DRAW);return b;}
const clouds=[
 {p:buf(tp),n:tn?buf(tn):null,count:(tp.length/3)|0,col:[0.31,0.56,0.91],
  on:true},
 {p:buf(sp),n:sn?buf(sn):null,count:(sp.length/3)|0,col:[0.94,0.58,0.25],
  on:true}];
// scene bounds -> center/scale
let mn=[1e9,1e9,1e9],mx=[-1e9,-1e9,-1e9];
for(const a of [tp,sp])for(let i=0;i<a.length;i+=3)for(let k=0;k<3;k++){
 if(a[i+k]<mn[k])mn[k]=a[i+k]; if(a[i+k]>mx[k])mx[k]=a[i+k];}
const ctr=[(mn[0]+mx[0])/2,(mn[1]+mx[1])/2,(mn[2]+mx[2])/2];
const rad=Math.max(mx[0]-mn[0],mx[1]-mn[1],mx[2]-mn[2])*0.75+1e-6;
let yaw=0.6,pitch=0.4,dist=2.6,panX=0,panY=0;
function mat(){
 const cy=Math.cos(yaw),sy=Math.sin(yaw),
       cp=Math.cos(pitch),sp_=Math.sin(pitch);
 // rotation rows (world -> view)
 const r=[cy,0,-sy, sy*sp_,cp,cy*sp_, sy*cp,-sp_,cy*cp];
 const s=1/rad;
 const f=3.0,near=0.05,far=40.0;   // simple perspective
 const d=dist;
 // mvp = P * [view translate] * [rot*s] * [translate -ctr]
 function mulv(m,v){return [m[0]*v[0]+m[1]*v[1]+m[2]*v[2],
  m[3]*v[0]+m[4]*v[1]+m[5]*v[2], m[6]*v[0]+m[7]*v[1]+m[8]*v[2]];}
 const asp=cv.width/cv.height;
 // column-major 4x4
 const M=new Float32Array(16);
 // linear part: rows of (rot * s)
 const L=r.map(x=>x*s);
 const tv=mulv(L,[-ctr[0],-ctr[1],-ctr[2]]);
 tv[0]+=panX; tv[1]+=panY; tv[2]-=d;
 // projection applied manually: x*f/asp, y*f, z -> depth
 const A=(far+near)/(near-far), B=2*far*near/(near-far);
 M[0]=L[0]*f/asp; M[4]=L[1]*f/asp; M[8]=L[2]*f/asp;  M[12]=tv[0]*f/asp;
 M[1]=L[3]*f;     M[5]=L[4]*f;     M[9]=L[5]*f;      M[13]=tv[1]*f;
 M[2]=L[6]*A*-1;  M[6]=L[7]*A*-1;  M[10]=L[8]*A*-1;  M[14]=(tv[2])*A*-1+B*-1;
 M[3]=-L[6];      M[7]=-L[7];      M[11]=-L[8];      M[15]=-tv[2];
 return {M:M,R:new Float32Array([r[0],r[3],r[6],r[1],r[4],r[7],
                                 r[2],r[5],r[8]])};
}
function draw(){
 const dpr=window.devicePixelRatio||1;
 cv.width=innerWidth*dpr; cv.height=innerHeight*dpr;
 gl.viewport(0,0,cv.width,cv.height);
 gl.enable(gl.DEPTH_TEST);
 gl.clearColor(0.063,0.075,0.094,1);
 gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
 const m=mat();
 gl.uniformMatrix4fv(uMVP,false,m.M);
 gl.uniformMatrix3fv(uROT,false,m.R);
 gl.uniform1f(uPS,Math.max(1.5,2.2*dpr/Math.sqrt(dist)));
 for(const c of clouds){
  if(!c.on)continue;
  gl.uniform3fv(uCOL,c.col);
  gl.bindBuffer(gl.ARRAY_BUFFER,c.p);
  gl.enableVertexAttribArray(aP);
  gl.vertexAttribPointer(aP,3,gl.FLOAT,false,0,0);
  if(c.n){gl.bindBuffer(gl.ARRAY_BUFFER,c.n);
   gl.enableVertexAttribArray(aN);
   gl.vertexAttribPointer(aN,3,gl.FLOAT,false,0,0);}
  else{gl.disableVertexAttribArray(aN);gl.vertexAttrib3f(aN,0,0,0);}
  gl.drawArrays(gl.POINTS,0,c.count);
 }
}
let drag=null;
cv.addEventListener("mousedown",e=>{drag={x:e.clientX,y:e.clientY,
 pan:e.shiftKey||e.button===2};});
addEventListener("mouseup",()=>drag=null);
addEventListener("mousemove",e=>{if(!drag)return;
 const dx=e.clientX-drag.x,dy=e.clientY-drag.y;
 if(drag.pan){panX+=dx*0.002*dist;panY-=dy*0.002*dist;}
 else{yaw+=dx*0.006;pitch=Math.max(-1.55,Math.min(1.55,pitch+dy*0.006));}
 drag.x=e.clientX;drag.y=e.clientY;draw();});
cv.addEventListener("wheel",e=>{e.preventDefault();
 dist*=Math.exp(e.deltaY*0.0012);
 dist=Math.max(0.3,Math.min(20,dist));draw();},{passive:false});
cv.addEventListener("contextmenu",e=>e.preventDefault());
addEventListener("keydown",e=>{
 if(e.key==="1"){clouds[0].on=!clouds[0].on;draw();}
 if(e.key==="2"){clouds[1].on=!clouds[1].on;draw();}});
addEventListener("resize",draw);
draw();
</script></body></html>
"""


def export_html(result_file: str, out_html: str, index: int = 0,
                max_points: int = 120000) -> int:
    """Generate the interactive viewer HTML for the ``index``-th pair of a
    results file (default the first, like the reference viewer)."""
    from ..io.ply import read_ply

    pair = _parse_results(result_file, index)
    if pair is None:
        print(f"no parsable pair #{index} in {result_file}", file=sys.stderr)
        return 1
    target, source, T = pair
    tp, tn = read_ply(target)
    sp, sn = read_ply(source)
    sp = sp @ T[:3, :3].T + T[:3, 3]
    if sn is not None:
        # normals by the inverse transpose (ResultViewer main.cpp:84-92)
        sn = sn @ np.linalg.inv(T[:3, :3])
    tp, tn = _subsample(tp.astype(np.float32),
                        None if tn is None else tn.astype(np.float32),
                        max_points)
    sp, sn = _subsample(sp.astype(np.float32),
                        None if sn is None else sn.astype(np.float32),
                        max_points, seed=1)

    html = (_HTML
            .replace("__TGT_NAME__", target.rsplit("/", 1)[-1])
            .replace("__SRC_NAME__", source.rsplit("/", 1)[-1])
            .replace("__TGT_P__", _b64(tp))
            .replace("__TGT_N__", "" if tn is None else _b64(tn))
            .replace("__SRC_P__", _b64(sp))
            .replace("__SRC_N__", "" if sn is None else _b64(sn)))
    with open(out_html, "w") as f:
        f.write(html)
    print(f"wrote interactive viewer: {out_html} "
          f"({tp.shape[0]}+{sp.shape[0]} points)")
    return 0
