"""Static training plots: moving-average and binned reward curves, and a
one-file overview of every reward component.

Counterpart of ``quadruped_gym_tpu/utils/plot.py``, with its entry points
and its files. The ``.html`` overview needs nothing outside the standard
library: plotly when it is installed, else a self-contained SVG +
vanilla-JS page, byte for byte the JAX package's. The PNG curves need
matplotlib, which is imported where a PNG is drawn, so the module imports
without it; ``have_matplotlib()`` says whether a PNG can be drawn.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

try:  # optional, as in the JAX package
    import plotly.graph_objects as go  # type: ignore

    _HAS_PLOTLY = True
except Exception:  # pragma: no cover
    _HAS_PLOTLY = False


def have_matplotlib() -> bool:
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def _pyplot():
    """matplotlib's pyplot on the file-only Agg backend."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _save(fig, save_path: Optional[str]):
    if not save_path:
        return fig
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    fig.savefig(save_path, dpi=120)
    _pyplot().close(fig)
    return save_path


def moving_average(x: np.ndarray, window: int) -> np.ndarray:
    if window <= 1:
        return np.asarray(x, float)
    k = np.ones(window) / window
    return np.convolve(np.asarray(x, float), k, mode="valid")


def plot_data_line(
    values: Sequence[float],
    window: int = 100,
    title: str = "Reward",
    ylabel: str = "reward",
    save_path: Optional[str] = None,
):
    """Moving-average curve with a rolling-std band (PNG; matplotlib)."""
    plt = _pyplot()
    v = np.asarray(values, float)
    fig, ax = plt.subplots(figsize=(10, 5))
    if len(v) >= max(2, window):
        ma = moving_average(v, window)
        xs = np.arange(len(ma)) + window - 1
        roll_std = np.array(
            [v[max(0, i - window + 1): i + 1].std() for i in xs]
        )
        ax.plot(xs, ma, lw=1.5, label=f"moving avg (w={window})")
        ax.fill_between(xs, ma - roll_std, ma + roll_std, alpha=0.25,
                        label="±1 std")
    ax.plot(np.arange(len(v)), v, alpha=0.25, lw=0.5, label="raw")
    ax.set_title(title)
    ax.set_xlabel("step")
    ax.set_ylabel(ylabel)
    ax.legend(loc="best")
    fig.tight_layout()
    return _save(fig, save_path)


def plot_data(
    values: Sequence[float],
    num_bins: int = 100,
    title: str = "Reward",
    ylabel: str = "reward",
    save_path: Optional[str] = None,
):
    """Binned mean ± std curve (PNG; matplotlib)."""
    v = np.asarray(values, float)
    n = max(1, len(v) // max(1, num_bins))
    nbins = len(v) // n
    if nbins == 0:
        return plot_data_line(values, 1, title, ylabel, save_path)
    plt = _pyplot()
    trimmed = v[: nbins * n].reshape(nbins, n)
    mean = trimmed.mean(axis=1)
    std = trimmed.std(axis=1)
    xs = (np.arange(nbins) + 0.5) * n
    fig, ax = plt.subplots(figsize=(10, 5))
    ax.plot(xs, mean, lw=1.5, label="bin mean")
    ax.fill_between(xs, mean - std, mean + std, alpha=0.25, label="±1 std")
    ax.set_title(title)
    ax.set_xlabel("step")
    ax.set_ylabel(ylabel)
    ax.legend(loc="best")
    fig.tight_layout()
    return _save(fig, save_path)


_HTML_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>%(title)s</title><style>
body{font-family:system-ui,sans-serif;margin:16px;background:#fff}
#legend{display:flex;flex-wrap:wrap;gap:4px 14px;margin:8px 0;font-size:13px}
#legend label{cursor:pointer;display:flex;align-items:center;gap:4px}
#legend .sw{width:14px;height:3px;display:inline-block}
#readout{font:12px monospace;color:#333;height:1.2em}
svg{border:1px solid #ddd;width:100%%;height:460px}
</style></head><body>
<h3>%(title)s</h3><div id="legend"></div><div id="readout"></div>
<svg id="chart" viewBox="0 0 1000 460" preserveAspectRatio="none"></svg>
<script>
const KEYS=%(keys)s, DATA=%(data)s, XS=%(xs)s;
const COLORS=["#1f77b4","#ff7f0e","#2ca02c","#d62728","#9467bd","#8c564b",
"#e377c2","#7f7f7f","#bcbd22","#17becf","#aec7e8","#ffbb78","#98df8a"];
const svg=document.getElementById("chart"),leg=document.getElementById("legend");
const W=1000,H=460,PX=46,PY=14;
const on=KEYS.map(()=>true);
function lims(){let lo=1/0,hi=-1/0;DATA.forEach((s,i)=>{if(!on[i])return;
 s.forEach(v=>{if(v<lo)lo=v;if(v>hi)hi=v;});});
 if(lo===1/0){lo=0;hi=1;} if(lo===hi){lo-=1;hi+=1;} return [lo,hi];}
function draw(){const [lo,hi]=lims();const n=XS.length;
 const sx=x=>PX+(W-PX-8)*(n<2?0:(x/(n-1))),
       sy=v=>H-PY-(H-2*PY)*(v-lo)/(hi-lo);
 let out="";
 for(let g=0;g<5;g++){const v=lo+(hi-lo)*g/4,y=sy(v);
  out+=`<line x1="${PX}" y1="${y}" x2="${W-8}" y2="${y}" stroke="#eee"/>`+
   `<text x="2" y="${y+4}" font-size="10" fill="#888">${v.toPrecision(3)}</text>`;}
 DATA.forEach((s,i)=>{if(!on[i])return;
  const pts=s.map((v,x)=>`${sx(x).toFixed(1)},${sy(v).toFixed(1)}`).join(" ");
  out+=`<polyline points="${pts}" fill="none" stroke="${COLORS[i%%COLORS.length]}"
   stroke-width="1.1" vector-effect="non-scaling-stroke"/>`;});
 out+=`<line id="cross" x1="-9" y1="${PY}" x2="-9" y2="${H-PY}" stroke="#aaa"/>`;
 svg.innerHTML=out;}
KEYS.forEach((k,i)=>{const l=document.createElement("label");
 l.innerHTML=`<input type="checkbox" checked><span class="sw" style="background:${
  COLORS[i%%COLORS.length]}"></span>${k}`;
 l.querySelector("input").onchange=e=>{on[i]=e.target.checked;draw();};
 leg.appendChild(l);});
svg.addEventListener("mousemove",e=>{const r=svg.getBoundingClientRect();
 const fx=(e.clientX-r.left)/r.width*W;const n=XS.length;
 const idx=Math.max(0,Math.min(n-1,Math.round((fx-PX)/(W-PX-8)*(n-1))));
 const c=document.getElementById("cross");
 if(c){const sx=PX+(W-PX-8)*(n<2?0:idx/(n-1));
  c.setAttribute("x1",sx);c.setAttribute("x2",sx);}
 document.getElementById("readout").textContent=
  `step ${XS[idx]}  `+KEYS.map((k,i)=>on[i]?`${k}=${
   DATA[i][idx].toPrecision(4)}`:null).filter(Boolean).join("  ");});
draw();
</script></body></html>
"""


def _write_interactive_html(
    comp: np.ndarray, keys: Sequence[str], save_path: str,
    title: str = "Reward components", max_points: int = 2000,
):
    """Self-contained interactive overview — no plotly, no CDN.

    Series are stride-decimated to ``max_points`` so multi-million-step
    training CSVs stay a few hundred KB of HTML."""
    import json as _json

    n = comp.shape[0]
    stride = max(1, n // max_points)
    sub = comp[::stride]
    xs = list(range(0, n, stride))
    page = _HTML_PAGE % {
        "title": title,
        "keys": _json.dumps(list(keys)),
        "data": _json.dumps(
            [[round(float(v), 5) for v in sub[:, i]]
             for i in range(len(keys))]
        ),
        "xs": _json.dumps(xs),
    }
    with open(save_path, "w") as f:
        f.write(page)
    return save_path


def plot_reward_components(
    components: np.ndarray,
    keys: Sequence[str],
    save_path: str,
    window: int = 100,
):
    """All reward components in one file. ``components``: (steps,
    n_components). An ``.html`` path gives the interactive page (plotly
    when installed, else the built-in SVG + JS document); any other
    extension the multi-panel PNG (matplotlib)."""
    comp = np.asarray(components, float)
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    if _HAS_PLOTLY and save_path.endswith(".html"):  # pragma: no cover
        fig = go.Figure()
        for i, k in enumerate(keys):
            fig.add_trace(go.Scatter(y=comp[:, i], name=k, mode="lines"))
        fig.update_layout(title="Reward components", xaxis_title="step")
        fig.write_html(save_path)
        return save_path
    if save_path.endswith(".html"):
        return _write_interactive_html(comp, keys, save_path)
    plt = _pyplot()
    ncols = 3
    nrows = (len(keys) + ncols - 1) // ncols
    fig, axes = plt.subplots(nrows, ncols, figsize=(4 * ncols, 2.5 * nrows),
                             squeeze=False)
    for i, k in enumerate(keys):
        ax = axes[i // ncols][i % ncols]
        v = comp[:, i]
        ax.plot(v, alpha=0.3, lw=0.5)
        if len(v) >= window:
            ax.plot(np.arange(window - 1, len(v)), moving_average(v, window),
                    lw=1.2)
        ax.set_title(k, fontsize=9)
    for j in range(len(keys), nrows * ncols):
        axes[j // ncols][j % ncols].axis("off")
    fig.tight_layout()
    return _save(fig, save_path)
