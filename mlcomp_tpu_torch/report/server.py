"""HTTP report server over the sqlite task store (stdlib only; the port's copy of
mlcomp_tpu/report/server.py).

Endpoints (all JSON unless noted):

- ``GET /``                                 HTML dashboard
- ``GET /api/dags``                         all dags + task status counts
- ``GET /api/dags/<id>/tasks``              task rows for one dag
- ``GET /api/tasks/<id>/logs``              log lines
- ``GET /api/tasks/<id>/metrics``           metric names
- ``GET /api/tasks/<id>/metrics/<name>``    one metric series [[step, value]]
- ``GET /api/workers``                      worker heartbeats
- ``GET /api/models``                       model-storage inventory
- ``GET /api/serving``                      live serve-daemon stats (proxy
  of ``MLCOMP_TPU_SERVE_URL``'s /healthz + prefix-cache /cache/stats
  hit/miss/eviction counters; ``{"configured": false}`` when unset)
- ``GET /metrics``                          Prometheus text exposition:
  DAG/task status counts, worker heartbeat ages, plus the proxied
  serve-daemon stats as scrapeable series (docs/observability.md)
- ``GET /fleet/trace``                      ONE merged Perfetto trace
  across every daemon in ``MLCOMP_TPU_SERVE_URLS`` (comma-separated
  base URLs; falls back to ``MLCOMP_TPU_SERVE_URL``): each daemon's
  ``/trace`` export lands under its own pid with a ``process_name``
  metadata record, timestamps aligned onto the report server's clock
  (per-daemon skew estimated from the scrape RTT midpoint), so a
  request's prefill on one replica renders against its neighbors.
  Forwards ``last_ms`` / ``trace_id`` to the daemons — a trace id
  minted on one daemon filters the whole fleet's view (``rid`` is NOT
  forwarded: rids are per-daemon counters, so one rid names a
  different request on every daemon)
- ``GET /fleet/metrics``                    one text exposition merging
  every daemon's ``/metrics`` with a ``daemon="host:port"`` label per
  sample (plus ``mlcomp_fleet_daemon_up``), so one scrape target
  compares replicas

Each request opens its own Store handle (sqlite connections are not
thread-safe across the ThreadingHTTPServer pool; WAL mode makes the
per-request open cheap and concurrent-reader-safe).

Mutation (POST) routes carry two guards: the ``X-Requested-With`` header
(CSRF — cross-origin browser calls become preflights this server never
answers) and, when ``MLCOMP_TPU_REPORT_TOKEN`` is set in the server's
environment, a matching ``Authorization: Bearer <token>`` header (the
dashboard forwards ``?token=`` from its URL).  With no env token the
server is open — the reference's dashboard is likewise unauthenticated
on a trusted network, so auth is opt-in, not mandatory.
"""

from __future__ import annotations

import hmac
import json
import os
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional, Tuple

from mlcomp_tpu_torch.db.store import Store

# ---------------------------------------------------------------- fleet
# The serving control plane's sight line (ROADMAP item 4's
# prerequisite): the report server scrapes every daemon in
# MLCOMP_TPU_SERVE_URLS and serves ONE merged Perfetto trace and ONE
# labeled metrics exposition, so a fleet of engine replicas is
# debuggable from a single pane before the scheduler ever manages one.


def _fleet_urls() -> "list[str]":
    """Daemon base URLs behind the /fleet surfaces.  The DYNAMIC
    registry first: ``MLCOMP_TPU_SERVE_REGISTRY`` names the JSON file
    the fleet ReplicaManager (and scheduler-launched replicas) keep
    current, so replicas spawned/restarted/moved at runtime appear here
    without an env edit.  The comma-separated ``MLCOMP_TPU_SERVE_URLS``
    list is the static fallback, then the single-daemon
    ``MLCOMP_TPU_SERVE_URL`` the /api/serving proxy already uses."""
    reg_path = os.environ.get("MLCOMP_TPU_SERVE_REGISTRY", "")
    if reg_path:
        from mlcomp_tpu_torch.fleet.registry import registry_urls

        urls = registry_urls(reg_path)
        if urls:
            return urls
    raw = os.environ.get("MLCOMP_TPU_SERVE_URLS", "")
    urls = [u.strip().rstrip("/") for u in raw.split(",") if u.strip()]
    if not urls:
        single = os.environ.get("MLCOMP_TPU_SERVE_URL", "").rstrip("/")
        if single:
            urls = [single]
    return urls


def _daemon_name(base: str) -> str:
    """``host:port`` — the ``daemon`` label value and process name."""
    return base.split("://", 1)[-1]


def _fetch_daemon(base: str, path: str, timeout: float = 3.0) -> bytes:
    import urllib.request

    headers = {}
    token = os.environ.get("MLCOMP_TPU_SERVE_TOKEN", "")
    if token:
        headers["Authorization"] = f"Bearer {token}"
    req = urllib.request.Request(base + path, headers=headers)
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read()


def _fetch_fleet(urls: "list[str]", fetch_one):
    """Run ``fetch_one(base)`` for every daemon CONCURRENTLY (stdlib
    thread pool), results in ``urls`` order.  The per-daemon timeout is
    3 s; serial scraping would make one dead daemon cost the whole
    fleet surface 3 s and an N-daemon fleet sum-of-RTTs."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=min(len(urls), 16)) as pool:
        return list(pool.map(fetch_one, urls))


def merge_fleet_trace(urls: "list[str]", query: str = "") -> dict:
    """Scrape each daemon's ``/trace`` and merge into one Chrome-trace
    body: one pid per daemon (named via ``process_name`` metadata), all
    timestamps mapped onto the REPORT SERVER's wall clock.

    Alignment: every daemon export is stamped with its wall clock and
    recorder clock read back to back (``clock_offset_us`` — see
    ``Tracer.export``), which maps events onto that daemon's unix time;
    the residual cross-host clock skew is estimated per scrape as the
    difference between the daemon's export stamp and this server's
    clock at the scrape's RTT MIDPOINT (the export happens roughly
    mid-request, so the midpoint is the unbiased read).  Good to ~RTT/2
    — read adjacency across daemons, not exact edges."""
    def fetch_one(base):
        # t0/t1 bracket THIS daemon's request on its own worker thread
        # — the RTT midpoint skew estimate needs the per-daemon pair,
        # not the pool's overall completion time
        t0 = time.time()
        try:
            body = json.loads(_fetch_daemon(
                base, "/trace" + (f"?{query}" if query else "")
            ))
        except Exception as e:
            return t0, time.time(), None, e
        return t0, time.time(), body, None

    events: list = []
    daemons: list = []
    fetched = _fetch_fleet(urls, fetch_one)
    for i, (base, (t0, t1, body, err)) in enumerate(zip(urls, fetched)):
        pid = i + 1
        info: dict = {"url": base, "pid": pid, "name": _daemon_name(base)}
        if err is not None:
            info["error"] = f"{type(err).__name__}: {err}"
            daemons.append(info)
            continue
        od = body.get("otherData") or {}
        offset = od.get("clock_offset_us")
        exp_unix = od.get("export_unix_us")
        mid_us = (t0 + t1) / 2 * 1e6
        skew_us = (exp_unix - mid_us) if exp_unix is not None else 0.0
        evs = body.get("traceEvents") or []
        info.update({
            "rtt_ms": round((t1 - t0) * 1e3, 2),
            "clock_skew_us": round(skew_us, 1),
            "dropped_events": od.get("dropped_events"),
            "events": len(evs),
        })
        for e in evs:
            e = dict(e)
            e["pid"] = pid
            if offset is not None and "ts" in e:
                # daemon recorder clock -> daemon unix -> our unix
                e["ts"] = float(e["ts"]) + offset - skew_us
            events.append(e)
        events.append({
            "name": "process_name", "ph": "M", "pid": pid,
            "args": {"name": _daemon_name(base)},
        })
        daemons.append(info)
    # rebase onto the earliest event so Perfetto opens at t=0 instead
    # of an epoch-sized offset
    ts_vals = [e["ts"] for e in events if "ts" in e]
    t_base = min(ts_vals) if ts_vals else 0.0
    for e in events:
        if "ts" in e:
            e["ts"] = e["ts"] - t_base
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"daemons": daemons, "t0_unix_us": t_base},
    }


_FLEET_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})? (\S+)$"
)
_FLEET_SUFFIX_RE = re.compile(r"_(bucket|sum|count)$")


def merge_fleet_metrics(urls: "list[str]") -> str:
    """Scrape each daemon's ``/metrics`` and merge into one exposition
    with a ``daemon="host:port"`` label injected into every sample.
    Families are grouped (one HELP/TYPE block per family, samples from
    all daemons contiguous under it — the 0.0.4 grouping rule), and
    ``mlcomp_fleet_daemon_up`` reports which daemons answered."""
    fams: dict = {}

    def fam_entry(name: str) -> dict:
        return fams.setdefault(
            name, {"help": None, "type": None, "samples": []}
        )

    def fetch_one(base):
        try:
            return _fetch_daemon(base, "/metrics").decode()
        except Exception:
            return None

    up: list = []
    for base, text in zip(urls, _fetch_fleet(urls, fetch_one)):
        daemon = _daemon_name(base)
        if text is None:
            up.append((daemon, 0))
            continue
        up.append((daemon, 1))
        types: dict = {}
        for line in text.splitlines():
            if not line.strip():
                continue
            if line.startswith("# HELP "):
                parts = line.split(" ", 3)
                if len(parts) == 4:
                    e = fam_entry(parts[2])
                    if e["help"] is None:
                        e["help"] = parts[3]
                continue
            if line.startswith("# TYPE "):
                parts = line.split(" ")
                if len(parts) == 4:
                    types[parts[2]] = parts[3]
                    e = fam_entry(parts[2])
                    if e["type"] is None:
                        e["type"] = parts[3]
                continue
            if line.startswith("#"):
                continue
            m = _FLEET_SAMPLE_RE.match(line)
            if not m:
                continue
            name, labels, value = m.group(1), m.group(2), m.group(3)
            stripped = _FLEET_SUFFIX_RE.sub("", name)
            fam = stripped if stripped in types else name
            dl = f'daemon="{daemon}"'
            if labels:
                relabeled = f"{name}{{{dl},{labels[1:-1]}}} {value}"
            else:
                relabeled = f"{name}{{{dl}}} {value}"
            fam_entry(fam)["samples"].append(relabeled)
    lines: list = [
        "# HELP mlcomp_fleet_daemon_up 1 when the daemon's /metrics "
        "answered this fleet scrape",
        "# TYPE mlcomp_fleet_daemon_up gauge",
    ]
    for daemon, ok in up:
        lines.append(f'mlcomp_fleet_daemon_up{{daemon="{daemon}"}} {ok}')
    for name, e in fams.items():
        if not e["samples"]:
            continue
        if e["help"]:
            lines.append(f"# HELP {name} {e['help']}")
        lines.append(f"# TYPE {name} {e['type'] or 'untyped'}")
        lines.extend(e["samples"])
    return "\n".join(lines) + "\n"


_POST_ROUTES = [
    (re.compile(r"^/api/dags/(\d+)/stop$"), "stop_dag"),
    (re.compile(r"^/api/dags/(\d+)/restart$"), "restart_dag"),
    (re.compile(r"^/api/tasks/(\d+)/stop$"), "stop_task"),
    (re.compile(r"^/api/tasks/(\d+)/restart$"), "restart_task"),
]

_ROUTES = [
    (re.compile(r"^/api/dags$"), "dags"),
    (re.compile(r"^/api/dags/(\d+)/tasks$"), "dag_tasks"),
    (re.compile(r"^/api/dags/(\d+)/metrics$"), "dag_metric_names"),
    (re.compile(r"^/api/dags/(\d+)/metrics/([\w./-]+)$"), "dag_metric_series"),
    (re.compile(r"^/api/tasks/(\d+)/logs$"), "task_logs"),
    (re.compile(r"^/api/tasks/(\d+)/metrics$"), "metric_names"),
    (re.compile(r"^/api/tasks/(\d+)/metrics/([\w./-]+)$"), "metric_series"),
    (re.compile(r"^/api/tasks/(\d+)/reports$"), "task_reports"),
    (re.compile(r"^/api/reports/(\d+)$"), "report_payload"),
    (re.compile(r"^/api/workers$"), "workers"),
    (re.compile(r"^/api/models$"), "models"),
    (re.compile(r"^/api/serving$"), "serving"),
]

_DASHBOARD = """<!doctype html>
<html><head><meta charset="utf-8"><title>mlcomp-tpu</title>
<style>
:root{color-scheme:light;
 --surface:#fcfcfb;--panel:#ffffff;--border:#e3e2de;
 --text:#0b0b0b;--text2:#52514e;--muted:#8a897f;
 --series:#2a78d6;--grid:#eeede9;
 --ok:#0a7d38;--bad:#c0262d;--warn:#9a6a00;--off:#777}
@media (prefers-color-scheme:dark){:root{color-scheme:dark;
 --surface:#1a1a19;--panel:#232322;--border:#3a3936;
 --text:#ffffff;--text2:#c3c2b7;--muted:#8a897f;
 --series:#3987e5;--grid:#31302d;
 --ok:#3fae6d;--bad:#e66767;--warn:#c98500;--off:#999}}
body{font-family:system-ui,sans-serif;margin:2rem;background:var(--surface);color:var(--text)}
h1{font-size:1.3rem} h2{font-size:1.05rem;margin-top:1.5rem;color:var(--text)}
table{border-collapse:collapse;width:100%;background:var(--panel)}
td,th{border:1px solid var(--border);padding:.35rem .6rem;font-size:.85rem;text-align:left;color:var(--text)}
th{background:var(--surface);color:var(--text2);font-weight:600}
a{color:var(--series)}
.chip{display:inline-flex;align-items:center;gap:.35rem}
.chip::before{content:'';width:.55rem;height:.55rem;border-radius:50%;background:currentColor}
.success{color:var(--ok)}.failed{color:var(--bad)}
.in_progress,.queued{color:var(--warn)}.not_ran,.skipped,.stopped{color:var(--off)}
pre{background:var(--panel);border:1px solid var(--border);color:var(--text2);
 padding:.8rem;font-size:.75rem;overflow:auto;max-height:20rem}
.charts{display:flex;flex-wrap:wrap;gap:1rem}
.chart{background:var(--panel);border:1px solid var(--border);border-radius:4px;padding:.6rem}
.chart h3{margin:.1rem 0 .4rem;font-size:.85rem;font-weight:600;color:var(--text2)}
.tip{position:fixed;pointer-events:none;background:var(--panel);border:1px solid var(--border);
 border-radius:4px;padding:.25rem .5rem;font-size:.75rem;color:var(--text);display:none;z-index:9}
#graph{background:var(--panel);border:1px solid var(--border);border-radius:4px}
.node{fill:var(--panel);stroke:var(--border)}
.nlabel{font-size:11px;fill:var(--text)}
.edge{stroke:var(--muted);stroke-width:1.2;fill:none;marker-end:url(#arr)}
</style></head><body>
<h1>mlcomp-tpu report</h1>
<h2>DAGs</h2><table id="dags"></table>
<h2>Graph <span id="dagsel"></span></h2><svg id="graph" width="100%" height="0"></svg>
<h2>Compare <select id="cmpsel"></select></h2>
<div id="compare" class="charts"></div>
<h2>Tasks</h2><table id="tasks"></table>
<h2>Workers</h2><table id="workers"></table>
<h2>Models</h2><table id="models"></table>
<h2>Task detail <span id="tasksel"></span></h2>
<div id="charts" class="charts"></div>
<div id="reports"></div>
<pre id="detail">select a task</pre>
<div id="tip" class="tip"></div>
<script>
const TOK=new URLSearchParams(location.search).get('token');
const HDRS=TOK?{'Authorization':'Bearer '+TOK}:{};
const J=u=>fetch(u,{headers:HDRS}).then(r=>r.json());
const SVG=(t,a)=>{const e=document.createElementNS('http://www.w3.org/2000/svg',t);
 for(const k in a)e.setAttribute(k,a[k]);return e};
let curDag=null,curTask=null;const repCache=new Map();
function row(tr,cells,head){const r=document.createElement('tr');
 for(const c of cells){const d=document.createElement(head?'th':'td');
  if(c instanceof Node)d.appendChild(c);else if(Array.isArray(c)){
   d.textContent=c[0];if(c[1]){d.className=c[1]+' chip'}}
  else d.textContent=c??'';r.appendChild(d);}
 tr.appendChild(r);}
function link(text,fn){const a=document.createElement('a');a.href='#';
 a.textContent=text;a.onclick=()=>{fn();return false};return a}

// layered DAG graph: x = dependency depth, y = slot within layer
function drawGraph(tasks){
 const g=document.getElementById('graph');g.innerHTML='';
 if(!tasks.length){g.setAttribute('height',0);return}
 const byName={},depth={};for(const t of tasks)byName[t.name]=t;
 const d=n=>{if(depth[n]!==undefined)return depth[n];depth[n]=0; // cycle guard
  const deps=JSON.parse(byName[n].depends||'[]');
  return depth[n]=deps.length?1+Math.max(...deps.map(d)):0};
 tasks.forEach(t=>d(t.name));
 const layers={};tasks.forEach(t=>{(layers[depth[t.name]]??=[]).push(t)});
 const W=170,H=46,ncol=Object.keys(layers).length;
 const nrow=Math.max(...Object.values(layers).map(l=>l.length));
 g.setAttribute('viewBox','0 0 '+(ncol*W+20)+' '+(nrow*H+20));
 g.setAttribute('height',Math.min(nrow*H+20,360));
 const defs=SVG('defs',{});const mk=SVG('marker',{id:'arr',viewBox:'0 0 8 8',
  refX:8,refY:4,markerWidth:7,markerHeight:7,orient:'auto'});
 const tri=SVG('path',{d:'M0 0L8 4L0 8z'});tri.setAttribute('fill','var(--muted)');
 mk.appendChild(tri);defs.appendChild(mk);g.appendChild(defs);
 const pos={};for(const[dep,list]of Object.entries(layers))
  list.forEach((t,i)=>pos[t.name]=[10+dep*W,10+i*H]);
 for(const t of tasks)for(const dn of JSON.parse(t.depends||'[]')){
  const[x1,y1]=pos[dn],[x2,y2]=pos[t.name];
  g.appendChild(SVG('path',{class:'edge',
   d:'M'+(x1+130)+' '+(y1+16)+' C'+(x1+155)+' '+(y1+16)+','+(x2-25)+' '+(y2+16)+','+x2+' '+(y2+16)}));}
 for(const t of tasks){const[x,y]=pos[t.name];
  g.appendChild(SVG('rect',{class:'node',x,y,width:130,height:32,rx:4}));
  const cls={success:'ok',failed:'bad',in_progress:'warn',queued:'warn'}[t.status];
  const dot=SVG('circle',{cx:x+12,cy:y+16,r:4});
  dot.setAttribute('fill',cls?'var(--'+cls+')':'var(--off)');g.appendChild(dot);
  const lb=SVG('text',{class:'nlabel',x:x+22,y:y+20});
  lb.textContent=t.name.length>15?t.name.slice(0,14)+'…':t.name;
  lb.appendChild(Object.assign(SVG('title',{}),{textContent:t.name+' — '+t.status}));
  g.appendChild(lb);}}

// single-series line chart with crosshair + tooltip; series: [[x,value]..]
function lineChart(name,series,xlabel='step'){
 const W=300,H=120,PL=44,PR=10,PT=8,PB=18;
 const box=document.createElement('div');box.className='chart';
 const h=document.createElement('h3');h.textContent=name;box.appendChild(h);
 const svg=SVG('svg',{width:W,height:H});box.appendChild(svg);
 const {X,Y,x1}=axes(svg,series.map(p=>p[0]),series.map(p=>p[1]),
  W,H,PL,PR,PT,PB);
 const xl=SVG('text',{x:W-PR,y:H-5,'text-anchor':'end','font-size':9});
 xl.setAttribute('fill','var(--text2)');xl.textContent=xlabel+' '+fmt(x1);svg.appendChild(xl);
 const path=SVG('path',{fill:'none','stroke-width':2,
  d:series.map((p,i)=>(i?'L':'M')+X(p[0]).toFixed(1)+' '+Y(p[1]).toFixed(1)).join('')});
 path.setAttribute('stroke','var(--series)');svg.appendChild(path);
 const last=series[series.length-1];
 const dl=SVG('text',{x:Math.min(X(last[0])+4,W-PR-28),y:Y(last[1])-5,'font-size':9});
 dl.setAttribute('fill','var(--text2)');dl.textContent=fmt(last[1]);svg.appendChild(dl);
 const cross=SVG('line',{y1:PT,y2:H-PB,visibility:'hidden'});
 cross.setAttribute('stroke','var(--muted)');svg.appendChild(cross);
 const dot=SVG('circle',{r:4,visibility:'hidden'});
 dot.setAttribute('fill','var(--series)');dot.setAttribute('stroke','var(--panel)');
 dot.setAttribute('stroke-width',2);svg.appendChild(dot);
 const tip=document.getElementById('tip');
 svg.onmousemove=e=>{const r=svg.getBoundingClientRect(),mx=e.clientX-r.left;
  let best=0,bd=1e9;series.forEach((p,i)=>{const d=Math.abs(X(p[0])-mx);
   if(d<bd){bd=d;best=i}});
  const p=series[best];
  cross.setAttribute('x1',X(p[0]));cross.setAttribute('x2',X(p[0]));
  cross.setAttribute('visibility','visible');
  dot.setAttribute('cx',X(p[0]));dot.setAttribute('cy',Y(p[1]));
  dot.setAttribute('visibility','visible');
  tip.style.display='block';tip.style.left=(e.clientX+12)+'px';
  tip.style.top=(e.clientY-10)+'px';
  tip.textContent=name+' @ '+xlabel+' '+fmt(p[0])+': '+fmt(p[1])};
 svg.onmouseleave=()=>{cross.setAttribute('visibility','hidden');
  dot.setAttribute('visibility','hidden');tip.style.display='none'};
 return box}

// categorical series color: golden-angle hue rotation, theme-stable
const seriesColor=i=>'hsl('+((i*137.5+210)%360)+' 62% 46%)';
const fmt=v=>Math.abs(v)>=100?v.toFixed(0):Math.abs(v)>=1?v.toFixed(2):v.toPrecision(3);

// shared chart scaffolding: scales from data extent + gridlines/labels
function axes(svg,xs,ys,W,H,PL,PR,PT,PB){
 let x0=Math.min(...xs),x1=Math.max(...xs),y0=Math.min(...ys),y1=Math.max(...ys);
 if(x0===x1)x1=x0+1; if(y0===y1){y0-=1;y1+=1}
 const X=v=>PL+(v-x0)/(x1-x0)*(W-PL-PR), Y=v=>PT+(1-(v-y0)/(y1-y0))*(H-PT-PB);
 for(let i=0;i<3;i++){const yv=y0+(y1-y0)*i/2,yy=Y(yv);
  const gl=SVG('line',{x1:PL,x2:W-PR,y1:yy,y2:yy});
  gl.setAttribute('stroke','var(--grid)');svg.appendChild(gl);
  const lb=SVG('text',{x:PL-4,y:yy+3,'text-anchor':'end','font-size':9});
  lb.setAttribute('fill','var(--text2)');lb.textContent=fmt(yv);svg.appendChild(lb);}
 return {X,Y,x1}}

// multi-series overlay: one metric across a DAG's tasks (grid compare)
function multiChart(name,byTask){
 const W=520,H=200,PL=48,PR=10,PT=8,PB=18;
 const entries=Object.entries(byTask).filter(([,s])=>s.length);
 if(!entries.length)return document.createTextNode('');
 const box=document.createElement('div');box.className='chart';
 const h=document.createElement('h3');h.textContent=name;box.appendChild(h);
 const svg=SVG('svg',{width:W,height:H});box.appendChild(svg);
 const {X,Y}=axes(svg,entries.flatMap(([,s])=>s.map(p=>p[0])),
  entries.flatMap(([,s])=>s.map(p=>p[1])),W,H,PL,PR,PT,PB);
 entries.forEach(([task,s],i)=>{
  const path=SVG('path',{fill:'none','stroke-width':1.8,
   d:s.map((p,k)=>(k?'L':'M')+X(p[0]).toFixed(1)+' '+Y(p[1]).toFixed(1)).join('')});
  path.setAttribute('stroke',seriesColor(i));
  path.appendChild(Object.assign(SVG('title',{}),
   {textContent:task+' (last '+fmt(s[s.length-1][1])+')'}));
  svg.appendChild(path);});
 const leg=document.createElement('div');
 leg.style.cssText='display:flex;flex-wrap:wrap;gap:.3rem .8rem;font-size:.72rem';
 entries.forEach(([task,s],i)=>{const it=document.createElement('span');
  it.className='chip';it.style.color=seriesColor(i);
  it.textContent=task+' · '+fmt(s[s.length-1][1]);leg.appendChild(it);});
 box.appendChild(leg);
 return box}

let cmpBusy=false;
async function refreshCompare(){
 const sel=document.getElementById('cmpsel');
 const div=document.getElementById('compare');
 if(curDag===null){div.innerHTML='';sel.innerHTML='';return}
 // don't collapse an open dropdown or interleave with an in-flight build
 if(cmpBusy||document.activeElement===sel)return;
 cmpBusy=true;
 try{
  const names=await J('/api/dags/'+curDag+'/metrics');
  const keep=sel.value;
  sel.innerHTML='';
  for(const n of names){const o=document.createElement('option');
   o.value=o.textContent=n;sel.appendChild(o);}
  if(names.includes(keep))sel.value=keep;
  sel.onchange=()=>{sel.blur();refreshCompare()};
  div.innerHTML='';
  if(sel.value){
   const byTask=await J('/api/dags/'+curDag+'/metrics/'+sel.value);
   if(Object.keys(byTask).length)div.appendChild(multiChart(sel.value,byTask));}
 }finally{cmpBusy=false}}

// confusion matrix heatmap: cell opacity ~ row-normalized count
function confusionTable(names,cm){
 const t=document.createElement('table');t.style.width='auto';
 row(t,['true\\\\pred',...names],true);
 cm.forEach((r,i)=>{const tr=document.createElement('tr');
  const th=document.createElement('th');th.textContent=names[i];tr.appendChild(th);
  const mx=Math.max(...r,1);
  r.forEach((v,j)=>{const td=document.createElement('td');
   td.textContent=v;td.style.textAlign='right';
   td.style.background=v?'color-mix(in srgb,'+
    (i===j?'var(--ok)':'var(--bad)')+' '+Math.round(12+60*v/mx)+'%,var(--panel))':'';
   tr.appendChild(td)});
  t.appendChild(tr)});
 return t}
function perClassTable(rows,cols){
 const t=document.createElement('table');t.style.width='auto';
 row(t,cols,true);
 for(const r of rows)row(t,cols.map(c=>typeof r[c]==='number'&&!Number.isInteger(r[c])
  ?r[c].toFixed(3):r[c]));
 return t}
function renderReport(div,rep,p,sections){
 // unknown kinds and error bodies must not brick the task-detail view
 if(!p||p.error||(p.kind!=='classification'&&p.kind!=='segmentation'))return;
 // sections: null = render everything (no layout declared); otherwise a
 // Set of panel types from the task's "layout" artifact
 const want=s=>!sections||sections.has(s);
 const h=document.createElement('h2');h.textContent='Report: '+rep.name+' ('+p.kind+')';
 div.appendChild(h);
 if(want('summary')){
  const sum=document.createElement('p');
  sum.textContent=p.kind==='segmentation'
   ?'pixel acc '+p.pixel_accuracy.toFixed(4)+' · mIoU '+p.mean_iou.toFixed(4)+
    ' · mean dice '+p.mean_dice.toFixed(4)+' · '+p.n_pixels+' px'
   :'accuracy '+p.accuracy.toFixed(4)+' · mAP '+p.mean_average_precision.toFixed(4)+
    ' · '+p.n+' samples';
  div.appendChild(sum)}
 if(want('pr_curves')&&p.pr_curves&&Object.keys(p.pr_curves).length){
  const ch=document.createElement('div');ch.className='charts';
  for(const[name,curve]of Object.entries(p.pr_curves))
   if(curve.length>1)ch.appendChild(lineChart('PR: '+name+
    ' (AP '+(p.average_precision[name]||0).toFixed(3)+')',curve,'recall'));
  div.appendChild(ch)}
 if(want('per_class')&&p.per_class){div.appendChild(perClassTable(p.per_class,
  p.kind==='segmentation'?['name','iou','dice','pixels']
   :['name','precision','recall','f1','support']))}
 if(want('confusion')&&p.confusion&&p.confusion.length<=64){ // matches artifacts max_confusion
  const hh=document.createElement('h3');hh.textContent='Confusion matrix';
  div.appendChild(hh);div.appendChild(confusionTable(p.class_names,p.confusion))}
 if(want('gallery')&&p.worst&&p.worst.length){
  const hh=document.createElement('h3');
  hh.textContent='Most-confident mistakes (gallery)';
  div.appendChild(hh);
  div.appendChild(perClassTable(p.worst,['index','true','pred','confidence']))}}

async function refresh(){
 const dags=await J('/api/dags');const t=document.getElementById('dags');
 t.innerHTML='';row(t,['id','name','project','status','tasks','actions'],true);
 const act=d=>{const span=document.createElement('span');
  const P=(verb)=>fetch('/api/dags/'+d.id+'/'+verb,{method:'POST',
   headers:{'X-Requested-With':'mlcomp-tpu',...HDRS}}).then(()=>refresh());
  if(d.status==='in_progress')span.appendChild(link('stop',()=>P('stop')));
  else if(d.status!=='success')span.appendChild(link('restart',()=>P('restart')));
  return span};
 for(const d of dags)
  row(t,[link(d.id,()=>{curDag=d.id;refresh()}),d.name,d.project,
   [d.status,d.status],JSON.stringify(d.counts),act(d)]);
 if(curDag===null&&dags.length)curDag=dags[dags.length-1].id;
 if(curDag!==null){
  document.getElementById('dagsel').textContent='(dag '+curDag+')';
  const tasks=await J('/api/dags/'+curDag+'/tasks');
  drawGraph(tasks);
  refreshCompare();
  const tt=document.getElementById('tasks');tt.innerHTML='';
  row(tt,['id','name','executor','stage','status','worker','error','actions'],true);
  const tact=x=>{const span=document.createElement('span');
   const P=(verb)=>fetch('/api/tasks/'+x.id+'/'+verb,{method:'POST',
    headers:{'X-Requested-With':'mlcomp-tpu',...HDRS}}).then(()=>refresh());
   if(['not_ran','queued','in_progress'].includes(x.status))
    span.appendChild(link('stop',()=>P('stop')));
   else span.appendChild(link('restart',()=>P('restart')));
   return span};
  for(const x of tasks)
   row(tt,[link(x.id,()=>showTask(x.id)),x.name,x.executor,x.stage,
    [x.status,x.status],x.worker||'',x.error||'',tact(x)]);}
 const ws=await J('/api/workers');const wt=document.getElementById('workers');
 wt.innerHTML='';row(wt,['name','chips','busy','status','load','free RAM','tasks','heartbeat'],true);
 for(const w of ws){let i={};try{i=JSON.parse(w.info||'{}')}catch(e){}
  row(wt,[w.name,w.chips,w.busy_chips,
   [w.status,w.status==='alive'?'success':'failed'],
   i.load1??'',i.mem_free_gb!==undefined?i.mem_free_gb+' GB':'',
   (i.tasks||[]).join(', '),
   new Date(w.heartbeat*1000).toLocaleTimeString()]);}
 const ms=await J('/api/models');const mt=document.getElementById('models');
 mt.innerHTML='';
 if(ms.length){row(mt,['project','dag','task','checkpoints','artifacts','updated'],true);
  for(const m of ms)row(mt,[m.project,m.dag,m.task,
   m.checkpoints.length?m.checkpoints.join(', '):'—',m.artifacts,
   m.updated?new Date(m.updated*1000).toLocaleString():'']);}
 else row(mt,['no stored models'],false);
 // skip the detail rebuild while the user is hovering a chart
 if(curTask!==null&&document.getElementById('tip').style.display!=='block')
  showTask(curTask);
}
async function showTask(id){
 curTask=id;
 document.getElementById('tasksel').textContent='(task '+id+')';
 const names=await J('/api/tasks/'+id+'/metrics');
 const series=await Promise.all(
  names.map(n=>J('/api/tasks/'+id+'/metrics/'+n)));
 // the task's declared dashboard layout, if any (a report artifact of
 // KIND 'layout', whatever its name, written from the YAML report:
 // section): series panels pick which metric charts render and in what
 // order; section panels pick which report parts render.  No layout =
 // render everything.  Payloads are immutable, so fetching them all
 // here costs nothing extra — the render loop below reuses repCache.
 const reps=await J('/api/tasks/'+id+'/reports');
 let layout=null;
 for(const rep of reps)
  try{let p=repCache.get(rep.id);
   if(!p){p=await J('/api/reports/'+rep.id);
    if(!p.error)repCache.set(rep.id,p)}
   if(p&&p.kind==='layout'&&!layout)layout=p.panels}
  catch(e){console.warn('layout fetch failed',e)}
 const ch=document.getElementById('charts');ch.innerHTML='';
 let out='';
 if(layout){
  for(const panel of layout)
   if(panel.type==='series')
    for(const m of panel.metrics){
     const i=names.indexOf(m);
     const s=i>=0?series[i]:[];
     if(s.length>1)ch.appendChild(lineChart(panel.title||m,s))}
  names.forEach((n,i)=>{const s=series[i];
   if(s.length)out+='metric '+n+' (last): '+s[s.length-1][1]+'\\n'})}
 else names.forEach((n,i)=>{const s=series[i];
  if(s.length>1)ch.appendChild(lineChart(n,s));
  if(s.length)out+='metric '+n+' (last): '+s[s.length-1][1]+'\\n'});
 const sections=layout?new Set(layout.map(p=>p.type)):null;
 const rdiv=document.getElementById('reports');rdiv.innerHTML='';
 for(const rep of reps)
  try{ // payloads are immutable: fetch each report id once per session
   let p=repCache.get(rep.id);
   if(!p){p=await J('/api/reports/'+rep.id);
    if(!p.error)repCache.set(rep.id,p)} // don't pin transient errors
   // skip LAYOUT payloads (panel config, consumed above — by kind
   // there too) by their kind, not their name: a user report that
   // happens to be NAMED 'layout' must still render
   if(p&&p.kind==='layout')continue;
   renderReport(rdiv,rep,p,sections)}
  catch(e){console.warn('report render failed',rep.id,e)}
 const logs=await J('/api/tasks/'+id+'/logs');
 for(const l of logs)out+='['+l.level+'] '+l.message+'\\n';
 document.getElementById('detail').textContent=out||'(empty)';
}
refresh();setInterval(refresh,3000);
</script></body></html>"""


class _Handler(BaseHTTPRequestHandler):
    db_path: str = ""

    def log_message(self, *args):  # quiet by default; logs go to the store
        pass

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, obj: Any, code: int = 200) -> None:
        self._send(code, json.dumps(obj).encode(), "application/json")

    def _dispatch(self, routes) -> None:
        path = self.path.split("?", 1)[0]
        for pat, name in routes:
            m = pat.match(path)
            if m:
                store = Store(self.db_path)
                try:
                    self._json(getattr(self, f"_r_{name}")(store, *m.groups()))
                except Exception as e:  # surface, don't kill the thread
                    self._json({"error": f"{type(e).__name__}: {e}"}, code=500)
                finally:
                    store.close()
                return
        self._json({"error": "not found"}, code=404)

    def _token_ok(self) -> bool:
        """True when no token is configured or the request bears it."""
        secret = os.environ.get("MLCOMP_TPU_REPORT_TOKEN", "")
        if not secret:
            return True
        auth = self.headers.get("Authorization", "")
        return hmac.compare_digest(auth, f"Bearer {secret}")

    def do_GET(self) -> None:  # noqa: N802 (http.server API)
        path, _, query = self.path.partition("?")
        if path in ("/", "/index.html"):
            # static shell only — every datum it shows comes from the
            # token-checked API routes below (the page forwards ?token=
            # as a bearer header on each fetch)
            self._send(200, _DASHBOARD.encode(), "text/html; charset=utf-8")
            return
        # a configured token guards READS too: task logs, metrics, and
        # report payloads are as sensitive as the mutation routes
        if not self._token_ok():
            self._json({"error": "invalid or missing token"}, code=403)
            return
        if path in ("/fleet/trace", "/fleet/metrics"):
            # fleet surfaces never touch the store — they scrape the
            # configured serve daemons
            urls = _fleet_urls()
            if not urls:
                self._json({
                    "error": "no serve daemons configured: set "
                    "MLCOMP_TPU_SERVE_URLS (comma-separated base "
                    "URLs) or MLCOMP_TPU_SERVE_URL",
                }, code=404)
                return
            try:
                if path == "/fleet/metrics":
                    from mlcomp_tpu_torch.obs.metrics import CONTENT_TYPE

                    body = merge_fleet_metrics(urls).encode()
                    self._send(200, body, CONTENT_TYPE)
                    return
                from urllib.parse import parse_qs, urlencode

                from mlcomp_tpu_torch.utils.trace import valid_trace_id

                qs = parse_qs(query)
                # validate BEFORE the fan-out: a malformed filter must
                # be a 400 here, not N daemon 400s silently merged
                # into an empty-but-200 trace
                params = {}
                if qs.get("last_ms"):
                    try:
                        last_ms = float(qs["last_ms"][0])
                    except ValueError:
                        last_ms = -1.0
                    if last_ms <= 0:
                        self._json({
                            "error": "last_ms must be a positive "
                            f"number, got {qs['last_ms'][0]!r}",
                        }, code=400)
                        return
                    params["last_ms"] = qs["last_ms"][0]
                if qs.get("trace_id"):
                    tid = qs["trace_id"][0].strip().lower()
                    if not valid_trace_id(tid):
                        self._json({
                            "error": "trace_id must be 32 hex chars, "
                            f"got {qs['trace_id'][0]!r}",
                        }, code=400)
                        return
                    params["trace_id"] = tid
                # last_ms and trace_id forward fleet-wide; rid does NOT
                # — rids are per-daemon monotonic counters, so one rid
                # names a DIFFERENT request on every daemon and the
                # merged "filtered" view would conflate them.  The
                # trace id is the globally-unique key; per-daemon rid
                # filtering belongs on that daemon's own /trace.
                self._json(merge_fleet_trace(urls, urlencode(params)))
            except Exception as e:  # surface, don't kill the thread
                self._json(
                    {"error": f"{type(e).__name__}: {e}"}, code=500
                )
            return
        if path == "/metrics":
            # Prometheus text, not JSON — rendered outside _dispatch
            from mlcomp_tpu_torch.obs.metrics import CONTENT_TYPE

            store = Store(self.db_path)
            try:
                body = self._render_metrics(store).encode()
            except Exception as e:
                self._json({"error": f"{type(e).__name__}: {e}"}, code=500)
                return
            finally:
                store.close()
            self._send(200, body, CONTENT_TYPE)
            return
        self._dispatch(_ROUTES)

    def do_POST(self) -> None:  # noqa: N802 (http.server API)
        # CSRF guard: a custom header makes any cross-origin browser call a
        # preflighted request, and this server never answers preflights —
        # so drive-by pages can't stop/restart DAGs.  curl users add
        # -H 'X-Requested-With: mlcomp-tpu'.
        if not self.headers.get("X-Requested-With"):
            self._json({"error": "missing X-Requested-With header"}, code=403)
            return
        if not self._token_ok():
            self._json({"error": "invalid or missing token"}, code=403)
            return
        self._dispatch(_POST_ROUTES)

    # ---- route impls -----------------------------------------------------

    def _r_dags(self, store: Store):
        dags = store.list_dags()
        for d in dags:
            counts: dict = {}
            for s in store.task_statuses(d["id"]).values():
                counts[s.value] = counts.get(s.value, 0) + 1
            d["counts"] = counts
        return dags

    def _r_dag_tasks(self, store: Store, dag_id: str):
        return store.task_rows(int(dag_id))

    def _r_dag_metric_names(self, store: Store, dag_id: str):
        return store.dag_metric_names(int(dag_id))

    def _r_dag_metric_series(self, store: Store, dag_id: str, name: str):
        return store.dag_metric_series(int(dag_id), name)

    def _r_task_logs(self, store: Store, task_id: str):
        return store.task_logs(int(task_id))

    def _r_metric_names(self, store: Store, task_id: str):
        return store.metric_names(int(task_id))

    def _r_metric_series(self, store: Store, task_id: str, name: str):
        return store.metric_series(int(task_id), name)

    def _r_task_reports(self, store: Store, task_id: str):
        return store.reports(int(task_id))

    def _r_report_payload(self, store: Store, report_id: str):
        payload = store.report_payload(int(report_id))
        return payload if payload is not None else {"error": "no such report"}

    def _r_stop_dag(self, store: Store, dag_id: str):
        return {"dag_id": int(dag_id), "stopped_tasks": store.stop_dag(int(dag_id))}

    def _r_restart_dag(self, store: Store, dag_id: str):
        return {"dag_id": int(dag_id), "reset_tasks": store.restart_dag(int(dag_id))}

    def _r_stop_task(self, store: Store, task_id: str):
        return {"task_id": int(task_id), "stopped": store.stop_task(int(task_id))}

    def _r_restart_task(self, store: Store, task_id: str):
        return {"task_id": int(task_id), "reset_tasks": store.restart_task(int(task_id))}

    def _r_workers(self, store: Store):
        return store.workers()

    def _r_serving(self, store: Store):
        """Live serving-daemon stats on the dashboard: proxies the
        `mlcomp-tpu serve` daemon named by ``MLCOMP_TPU_SERVE_URL``
        (e.g. http://127.0.0.1:8900) — /healthz plus, when the daemon
        runs a prefix cache, its /cache/stats hit/miss/eviction
        counters.  Unconfigured is not an error: the dashboard just
        shows serving as absent."""
        import urllib.error
        import urllib.request

        base = os.environ.get("MLCOMP_TPU_SERVE_URL", "").rstrip("/")
        if not base:
            return {"configured": False}
        headers = {}
        token = os.environ.get("MLCOMP_TPU_SERVE_TOKEN", "")
        if token:
            headers["Authorization"] = f"Bearer {token}"

        def fetch(path):
            req = urllib.request.Request(base + path, headers=headers)
            try:
                with urllib.request.urlopen(req, timeout=2) as r:
                    return json.loads(r.read())
            except urllib.error.HTTPError as e:
                if e.code == 503:
                    # unhealthy-but-alive (the watchdog flipped
                    # /healthz): the body still carries full stats —
                    # reachable, with healthy=false in the payload
                    return json.loads(e.read())
                raise

        out: dict = {"configured": True, "url": base}
        try:
            out["health"] = fetch("/healthz")
        except (urllib.error.URLError, OSError, ValueError) as e:
            out["reachable"] = False
            out["error"] = f"{type(e).__name__}: {e}"
            return out
        out["reachable"] = True
        # serving-latency + dispatch-pipeline counters for the
        # dashboard, lifted out of the health payload: p50/p95/p99
        # TTFT / per-token percentiles and the engine's pipeline
        # overlap metrics (in-flight depth, host-hidden ms per
        # dispatch, occupancy).  Absent (None) for window/speculative
        # daemons — the dashboard shows them only when present.
        health = out["health"]
        eng = health.get("engine") or {}
        out["latency"] = health.get("latency") or eng.get("latency")
        out["pipeline"] = eng.get("pipeline")
        try:
            out["prefix_cache"] = fetch("/cache/stats")
        except (urllib.error.URLError, OSError, ValueError):
            out["prefix_cache"] = None  # daemon runs without the cache
        return out

    def _render_metrics(self, store: Store) -> str:
        """``GET /metrics``: one Prometheus exposition aggregating the
        store's DAG/task/worker state with the proxied serve daemon's
        stats (the same /api/serving payload, re-exposed as scrapeable
        series) — a single scrape target covers the whole deployment
        even though workers and the serve daemon have no scrape port
        of their own."""
        from mlcomp_tpu_torch.obs.metrics import Registry

        reg = Registry()
        dag_g = reg.gauge(
            "mlcomp_report_dags", "DAGs by status", labelnames=("status",)
        )
        task_g = reg.gauge(
            "mlcomp_report_tasks", "Tasks by status across all DAGs",
            labelnames=("status",),
        )
        dag_counts: dict = {}
        task_counts: dict = {}
        for d in store.list_dags():
            dag_counts[d["status"]] = dag_counts.get(d["status"], 0) + 1
            for s in store.task_statuses(d["id"]).values():
                task_counts[s.value] = task_counts.get(s.value, 0) + 1
        for status, n in sorted(dag_counts.items()):
            dag_g.set(n, status=status)
        for status, n in sorted(task_counts.items()):
            task_g.set(n, status=status)
        now = time.time()
        alive = 0
        for w in store.workers():
            alive += 1 if w["status"] == "alive" else 0
            labels = {"worker": w["name"]}
            reg.gauge(
                "mlcomp_report_worker_heartbeat_age_seconds",
                "Seconds since the worker's last heartbeat",
                labelnames=("worker",),
            ).set(max(0.0, now - float(w["heartbeat"])), **labels)
            reg.gauge(
                "mlcomp_report_worker_chips", "Chips the worker advertises",
                labelnames=("worker",),
            ).set(w["chips"], **labels)
            reg.gauge(
                "mlcomp_report_worker_busy_chips",
                "Chips pinned to running tasks",
                labelnames=("worker",),
            ).set(w["busy_chips"], **labels)
        reg.gauge(
            "mlcomp_report_workers_alive", "Workers currently alive"
        ).set(alive)

        serving = self._r_serving(store)
        up = reg.gauge(
            "mlcomp_serving_up",
            "1 when MLCOMP_TPU_SERVE_URL answers /healthz, 0 when not "
            "(absent when unconfigured)",
        )
        if serving.get("configured"):
            up.set(1 if serving.get("reachable") else 0)
        if serving.get("reachable"):
            health = serving.get("health") or {}
            eng = health.get("engine") or {}

            def ctr(name, help, value):
                if value is not None:
                    reg.counter(name, help).set_total(float(value))

            def gau(name, help, value, **labels):
                if value is not None:
                    reg.gauge(
                        name, help, labelnames=tuple(labels)
                    ).set(float(value), **labels)

            ctr("mlcomp_serving_requests_total",
                "Requests the serve daemon has accepted",
                health.get("requests"))
            gau("mlcomp_serving_queue_depth",
                "Requests queued at the daemon", health.get("queue_depth"))
            ctr("mlcomp_serving_dispatches_total",
                "Engine decode dispatches", eng.get("dispatches"))
            ctr("mlcomp_serving_emitted_tokens_total",
                "Tokens emitted to requests", eng.get("emitted_tokens"))
            gau("mlcomp_serving_active_slots", "Slots currently decoding",
                eng.get("active_slots"))
            lat = serving.get("latency") or {}
            ctr("mlcomp_serving_latency_samples_total",
                "Requests behind the latency percentiles (lifetime)",
                lat.get("lifetime_samples"))
            for key in ("ttft_ms", "per_token_ms"):
                pcts = lat.get(key) or {}
                for q in ("p50", "p95", "p99"):
                    gau(f"mlcomp_serving_{key.replace('_ms', '')}_ms",
                        f"Serve daemon {key} percentile (windowed)",
                        pcts.get(q), quantile=q)
            pl = serving.get("pipeline") or {}
            gau("mlcomp_serving_pipeline_overlap_efficiency",
                "Host ms hidden / host ms total at the engine",
                pl.get("overlap_efficiency"))
            gau("mlcomp_serving_pipeline_occupancy",
                "Mean in-flight dispatch depth at issue",
                pl.get("occupancy"))
            # device-time attribution (engine /profile captures or the
            # steady-state estimate), lifted so fleet dashboards can
            # chart the device/host split and roofline utilization per
            # daemon without scraping each one
            dev = eng.get("device") or {}
            gau("mlcomp_serving_device_time_ms_per_dispatch",
                "Device-lane busy ms per dispatch at the daemon "
                "(capture-sourced when one ran, else estimated)",
                dev.get("device_time_ms_per_dispatch"))
            gau("mlcomp_serving_host_overhead_ms_per_dispatch",
                "Non-device ms per dispatch at the daemon",
                dev.get("host_overhead_ms_per_dispatch"))
            gau("mlcomp_serving_roofline_utilization",
                "HBM-roofline dispatch time / measured device time at "
                "the daemon",
                dev.get("roofline_utilization"))
            ctr("mlcomp_serving_profile_captures_total",
                "Device-profile captures the daemon completed",
                dev.get("captures"))
            # resilience state: health verdict, watchdog activity and
            # admission-control rejects, lifted from the same /healthz
            # payload so one scrape target alerts on a sick daemon
            gau("mlcomp_serving_engine_healthy",
                "1 while the daemon reports itself healthy (503 = 0)",
                1 if health.get("healthy", True) else 0)
            wd = eng.get("watchdog") or {}
            ctr("mlcomp_serving_watchdog_stalls_total",
                "Watchdog stall detections at the daemon",
                wd.get("stalls"))
            ctr("mlcomp_serving_watchdog_restarts_total",
                "Watchdog drive-loop restarts at the daemon",
                wd.get("restarts"))
            rej_c = reg.counter(
                "mlcomp_serving_requests_rejected_total",
                "Requests the daemon's admission control fast-failed",
                labelnames=("reason",),
            )
            for reason, n in sorted(health.get("rejected", {}).items()):
                rej_c.set_total(float(n), reason=reason)
            pc = serving.get("prefix_cache") or {}
            ctr("mlcomp_serving_prefix_cache_hits_total",
                "Prefix-cache lookup hits", pc.get("hits"))
            ctr("mlcomp_serving_prefix_cache_misses_total",
                "Prefix-cache lookup misses", pc.get("misses"))
            gau("mlcomp_serving_prefix_cache_bytes",
                "Prefix-cache resident bytes", pc.get("bytes"))
        return reg.render()

    def _r_models(self, store: Store):
        """Read-only walk of the ModelStorage tree (project/dag/task) —
        deliberately avoids ModelStorage's accessors, which mkdir."""
        from mlcomp_tpu_torch.io.storage import ModelStorage

        root = ModelStorage().root
        out = []
        if not root.is_dir():
            return out
        for d in sorted(p for p in root.glob("*/*/*") if p.is_dir()):
            project, dag, task = d.relative_to(root).parts
            ckpt_dir, art_dir = d / "checkpoints", d / "artifacts"
            meta_p = d / "meta.json"
            try:
                meta = json.loads(meta_p.read_text()) if meta_p.exists() else {}
            except (OSError, ValueError):
                meta = {}
            out.append({
                "project": project,
                "dag": dag,
                "task": task,
                "checkpoints": sorted(
                    (p.name for p in ckpt_dir.iterdir()),
                    # step dirs are numeric: 7, 9, 10 — not 10, 7, 9
                    key=lambda n: (not n.isdigit(), int(n) if n.isdigit() else n),
                ) if ckpt_dir.is_dir() else [],
                "artifacts": len(list(art_dir.iterdir()))
                if art_dir.is_dir() else 0,
                "updated": meta.get("updated"),
            })
        return out


def make_server(
    db_path: str, host: str = "127.0.0.1", port: int = 8765
) -> ThreadingHTTPServer:
    handler = type("BoundHandler", (_Handler,), {"db_path": db_path})
    return ThreadingHTTPServer((host, port), handler)


def start_in_thread(
    db_path: str, host: str = "127.0.0.1", port: int = 0
) -> Tuple[ThreadingHTTPServer, int]:
    """Start on an ephemeral port; returns (server, bound_port)."""
    srv = make_server(db_path, host, port)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv, srv.server_address[1]


def serve(db_path: str, host: str = "127.0.0.1", port: int = 8765) -> None:
    srv = make_server(db_path, host, port)
    print(f"mlcomp-tpu report server on http://{host}:{port} (db: {db_path})")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        srv.shutdown()
