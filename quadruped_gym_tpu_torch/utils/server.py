"""Live training dashboard on the standard library's ``http.server``.

Counterpart of ``quadruped_gym_tpu/utils/server.py``: one HTML page (the
total reward, every component, a filterable tail of the raw rows) that
polls a ``/data`` JSON endpoint; the handler re-reads the reward CSV on
each request, so the page follows a run that is still writing it."""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .metrics import read_reward_csv

_PAGE = r"""<!DOCTYPE html>
<html><head><title>quadruped-gym-tpu training</title>
<style>
 body{font-family:sans-serif;margin:20px;background:#fafafa}
 .tab{display:inline-block;padding:6px 14px;cursor:pointer;border:1px solid #ccc;
      border-bottom:none;background:#eee;border-radius:4px 4px 0 0}
 .tab.active{background:#fff;font-weight:bold}
 canvas{border:1px solid #ddd;background:#fff;width:100%;height:380px}
 table{border-collapse:collapse;font-size:12px}
 td,th{border:1px solid #ccc;padding:2px 6px}
</style></head><body>
<h2>quadruped-gym-tpu — live training metrics</h2>
<div id="tabs"></div>
<div id="view"><canvas id="c" width="1200" height="380"></canvas></div>
<div id="tbl"></div>
<script>
let mode='total', data=null, filt='';
const tabs=[['total','Total reward'],['components','Components'],['raw','Raw tail']];
function drawTabs(){
  document.getElementById('tabs').innerHTML=tabs.map(
    t=>`<span class="tab ${t[0]==mode?'active':''}" onclick="mode='${t[0]}';render()">${t[1]}</span>`
  ).join('');
}
function line(ctx,xs,ys,color,W,H,ymin,ymax){
  ctx.strokeStyle=color;ctx.beginPath();
  for(let i=0;i<ys.length;i++){
    const x=i/(ys.length-1||1)*W, y=H-(ys[i]-ymin)/((ymax-ymin)||1)*H;
    i?ctx.lineTo(x,y):ctx.moveTo(x,y);
  }
  ctx.stroke();
}
function render(){
  drawTabs();
  if(!data) return;
  const cv=document.getElementById('c'),ctx=cv.getContext('2d');
  ctx.clearRect(0,0,cv.width,cv.height);
  document.getElementById('tbl').innerHTML='';
  if(mode=='raw'){
    cv.style.display='none';
    // filterable raw table (the reference's Dash DataTable filter row,
    // server.py:80-142): space-separated terms; `name` keeps matching
    // columns, `col>x` / `col<x` filter rows on that column's value
    const cols=['step','total'].concat(data.keys);
    let keep=cols.map((c,i)=>i), rowpred=[];
    for(const term of (filt||'').trim().split(/\s+/).filter(t=>t)){
      const m=term.match(/^([a-zA-Z_]+)([<>])(-?[\d.]+)$/);
      if(m){
        const ci=cols.findIndex(c=>c.includes(m[1]));
        if(ci>=0) rowpred.push(r=> m[2]=='>' ? +r[ci]>+m[3] : +r[ci]<+m[3]);
      } else {
        keep=keep.filter(i=>i<2||cols[i].includes(term));
      }
    }
    let rows=data.rows.filter(r=>rowpred.every(p=>p(r))).slice(-30);
    document.getElementById('tbl').innerHTML=
      `<p><input id="f" size="40" value="${filt}" `+
      `placeholder="filter: e.g. heading total>5" `+
      `oninput="filt=this.value;render();`+
      `let e=document.getElementById('f');e.focus();e.selectionStart=e.value.length"></p>`+
      '<table><tr>'+keep.map(i=>`<th>${cols[i]}</th>`).join('')+'</tr>'+
      rows.map(r=>'<tr>'+keep.map(i=>`<td>${(+r[i]).toFixed(3)}</td>`).join('')+'</tr>').join('')+'</table>';
    return;
  }
  cv.style.display='block';
  if(mode=='total'){
    const ys=data.rows.map(r=>+r[1]);
    const mn=Math.min(...ys),mx=Math.max(...ys);
    line(ctx,null,ys,'#1f77b4',cv.width,cv.height,mn,mx);
    ctx.fillStyle='#333';ctx.fillText(`total reward  [${mn.toFixed(2)}, ${mx.toFixed(2)}]  n=${ys.length}`,10,12);
  } else {
    const colors=['#1f77b4','#ff7f0e','#2ca02c','#d62728','#9467bd','#8c564b',
                  '#e377c2','#7f7f7f','#bcbd22','#17becf','#393b79'];
    let mn=1e30,mx=-1e30;
    const series=data.keys.map((k,i)=>data.rows.map(r=>+r[2+i]));
    series.forEach(ys=>{mn=Math.min(mn,...ys);mx=Math.max(mx,...ys);});
    series.forEach((ys,i)=>line(ctx,null,ys,colors[i%colors.length],cv.width,cv.height,mn,mx));
    ctx.fillStyle='#333';
    data.keys.forEach((k,i)=>{ctx.fillStyle=colors[i%colors.length];ctx.fillText(k,10,14+12*i);});
  }
}
async function poll(){
  try{ data=await (await fetch('/data')).json(); render(); }catch(e){}
  setTimeout(poll,1000);
}
poll();
</script></body></html>"""


class _Handler(BaseHTTPRequestHandler):
    csv_path = "rewards_continuous.csv"
    max_rows = 5000

    def log_message(self, *a):  # silence request logging
        pass

    def do_GET(self):
        if self.path.startswith("/data"):
            if os.path.exists(self.csv_path):
                steps, totals, comp, keys = read_reward_csv(self.csv_path)
                n = len(steps)
                s = max(0, n - self.max_rows)
                rows = [
                    [int(steps[i]), float(totals[i])] + comp[i].tolist()
                    for i in range(s, n)
                ]
                payload = {"keys": list(keys), "rows": rows}
            else:
                payload = {"keys": [], "rows": []}
            body = json.dumps(payload).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
        else:
            body = _PAGE.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def launch_dash(csv_file_path: str, host: str = "127.0.0.1", port: int = 8050,
                block: bool = True):
    """Serve the live dashboard. With block=False it runs in a daemon
    thread and returns the server object (``port=0`` takes a free port:
    ``srv.server_address``).

    The default bind is loopback only: the dashboard shows a CSV with no
    authentication, so serving on every interface is an explicit opt-in
    through ``host="0.0.0.0"``."""
    handler = type("Handler", (_Handler,), {"csv_path": csv_file_path})
    srv = ThreadingHTTPServer((host, port), handler)
    if block:
        srv.serve_forever()
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv
