"""Interactive 3-D scatter as one self-contained HTML file, the port's own
copy of ``flocoder_tpu/utils/interactive_scatter.py``: the points embedded
as JSON, a small vanilla-JS canvas renderer with drag to rotate, wheel to
zoom, hover tooltips and a legend whose entries toggle their trace. numpy
and json only; the page fetches nothing. ``utils/codebook_analysis.py``
writes one beside each of its 3-D scatter PNGs.
"""
from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np

__all__ = ["export_scatter3d_html"]

_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title>
<style>
 body{margin:0;font:13px system-ui,sans-serif;background:#111;color:#ddd}
 #wrap{display:flex;height:100vh}
 canvas{flex:1;cursor:grab}
 #side{width:200px;padding:10px;overflow:auto}
 .leg{cursor:pointer;margin:4px 0;user-select:none}
 .leg.off{opacity:.3}
 .sw{display:inline-block;width:10px;height:10px;border-radius:5px;
     margin-right:6px}
 #tip{position:fixed;pointer-events:none;background:#000c;padding:4px 8px;
      border-radius:4px;display:none;white-space:pre}
 h3{margin:4px 0 10px;font-size:14px}
 #hint{opacity:.5;font-size:11px;margin-top:12px}
</style></head><body>
<div id="wrap"><canvas id="c"></canvas><div id="side">
<h3>__TITLE__</h3><div id="legend"></div>
<div id="hint">drag: rotate &middot; wheel: zoom<br>hover: inspect &middot;
click legend: toggle</div>
</div></div><div id="tip"></div>
<script>
const DATA=__DATA__;
const cv=document.getElementById('c'),cx=cv.getContext('2d');
const tip=document.getElementById('tip');
let rx=-0.5,ry=0.6,zoom=1,drag=null;
// normalize points to unit box around the centroid
let all=[];DATA.traces.forEach(t=>t.pts.forEach(p=>all.push(p)));
const n=all.length||1;
const mean=[0,1,2].map(i=>all.reduce((s,p)=>s+p[i],0)/n);
let rad=Math.sqrt(Math.max(...all.map(p=>
  (p[0]-mean[0])**2+(p[1]-mean[1])**2+(p[2]-mean[2])**2),1e-9));
const viridis=v=>{ // few-stop viridis ramp, v in [0,1]
  const s=[[68,1,84],[59,82,139],[33,145,140],[94,201,98],[253,231,37]];
  const x=Math.min(Math.max(v,0),1)*(s.length-1),i=Math.min(Math.floor(x),
    s.length-2),f=x-i;
  return `rgb(${s[i].map((c,k)=>Math.round(c+(s[i+1][k]-c)*f)).join(',')})`};
let proj=[];
function draw(){
  const W=cv.clientWidth,H=cv.clientHeight;
  if(cv.width!==W||cv.height!==H){cv.width=W;cv.height=H}
  cx.clearRect(0,0,W,H);
  const scale=Math.min(W,H)*0.38*zoom/rad;
  const ca=Math.cos(ry),sa=Math.sin(ry),cb=Math.cos(rx),sb=Math.sin(rx);
  proj=[];
  DATA.traces.forEach((t,ti)=>{
    if(t.off)return;
    t.pts.forEach((p,pi)=>{
      const x0=p[0]-mean[0],y0=p[1]-mean[1],z0=p[2]-mean[2];
      const x1=ca*x0+sa*z0,z1=-sa*x0+ca*z0;
      const y2=cb*y0-sb*z1,z2=sb*y0+cb*z1;
      const px=W/2+x1*scale,py=H/2-y2*scale;
      const col=t.vals?viridis((t.vals[pi]-t.vmin)/((t.vmax-t.vmin)||1)):
        t.color;
      const r=Math.max(2,5+z2/rad*2);
      cx.globalAlpha=0.85;cx.fillStyle=col;
      cx.beginPath();cx.arc(px,py,r,0,6.3);cx.fill();
      proj.push({px,py,ti,pi});
    });
  });
  cx.globalAlpha=1;
}
function legend(){
  const el=document.getElementById('legend');el.innerHTML='';
  DATA.traces.forEach((t,i)=>{
    const d=document.createElement('div');
    d.className='leg'+(t.off?' off':'');
    d.innerHTML=`<span class="sw" style="background:${t.vals?
      'linear-gradient(90deg,#440154,#fde725)':t.color}"></span>`+
      `${t.name} (${t.pts.length})`;
    d.onclick=()=>{t.off=!t.off;legend();draw()};
    el.appendChild(d);
  });
}
cv.onmousedown=e=>{drag=[e.clientX,e.clientY];cv.style.cursor='grabbing'};
window.onmouseup=()=>{drag=null;cv.style.cursor='grab'};
window.onmousemove=e=>{
  if(drag){ry+=(e.clientX-drag[0])*0.01;rx+=(e.clientY-drag[1])*0.01;
    drag=[e.clientX,e.clientY];draw();return}
  const r=cv.getBoundingClientRect(),mx=e.clientX-r.left,my=e.clientY-r.top;
  let best=null,bd=100;
  proj.forEach(q=>{const d=(q.px-mx)**2+(q.py-my)**2;
    if(d<bd){bd=d;best=q}});
  if(best){const t=DATA.traces[best.ti],p=t.pts[best.pi];
    tip.style.display='block';
    tip.style.left=(e.clientX+12)+'px';tip.style.top=(e.clientY+12)+'px';
    tip.textContent=`${t.name}\\n(${p.map(v=>v.toFixed(3)).join(', ')})`+
      (t.vals?`\\nvalue: ${t.vals[best.pi].toFixed(3)}`:'')+
      (t.labels?`\\n${t.labels[best.pi]}`:'');}
  else tip.style.display='none';
};
cv.onwheel=e=>{e.preventDefault();zoom*=e.deltaY<0?1.1:0.9;draw()};
window.onresize=draw;legend();draw();
</script></body></html>
"""

_PALETTE = ("#4477dd", "#dd4444", "#9944bb", "#33aa66", "#ee9922")


def export_scatter3d_html(path: str, traces: Sequence[dict],
                          title: str = "3D scatter") -> Optional[str]:
    """Write a self-contained interactive 3-D scatter.

    ``traces``: iterable of dicts with
      - ``name``: legend label
      - ``points``: (N, 3+) array (first three dims plotted)
      - ``color``: optional CSS color (default: palette by index)
      - ``values``: optional (N,) floats → viridis-colored with hover value
      - ``labels``: optional list of N hover strings
    Returns the path (None if every trace is empty)."""
    payload = []
    for i, tr in enumerate(traces):
        pts = np.asarray(tr["points"], dtype=np.float64)
        if pts.size == 0:
            continue
        entry = {
            "name": str(tr["name"]),
            "pts": [[round(float(v), 5) for v in p[:3]] for p in pts],
            "color": tr.get("color") or _PALETTE[i % len(_PALETTE)],
        }
        vals = tr.get("values")
        if vals is not None:
            vals = np.asarray(vals, dtype=np.float64)
            entry["vals"] = [round(float(v), 5) for v in vals]
            entry["vmin"] = float(vals.min())
            entry["vmax"] = float(vals.max())
        labels = tr.get("labels")
        if labels is not None:
            entry["labels"] = [str(x) for x in labels]
        payload.append(entry)
    if not payload:
        return None
    html = (_TEMPLATE
            .replace("__TITLE__", str(title))
            .replace("__DATA__", json.dumps({"traces": payload})))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(html)
    return path
