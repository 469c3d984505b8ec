"""Render the dry run's JSON results as roofline and memory tables.

    PYTHONPATH=src python -m repro_torch.roofline.report reports/dryrun.json

The port of ``repro/roofline/report.py``, on the H100's figures
(``roofline/hw.py``): the useful-compute fraction is against the card's
bf16 peak, and the memory table holds each cell's per-card peak against
its HBM.
"""

from __future__ import annotations

import json
import sys
from typing import Dict, List

from . import hw

__all__ = ["roofline_fraction", "roofline_fraction_overlap", "render_table",
           "render_memory_table", "summarize"]


def _fmt_s(x: float) -> str:
    if x >= 1.0:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


def roofline_fraction(r: Dict) -> float:
    """Useful-compute fraction: MODEL_FLOPS / (cards * peak * bound_time),
    the bound the no-overlap sum of the three terms."""
    t = r["terms"]
    step = t["compute_s"] + t["memory_s"] + t["collective_s"]
    if step <= 0 or not r.get("model_flops"):
        return 0.0
    return r["model_flops"] / (t["n_chips"] * hw.PEAK_FLOPS_BF16 * step)


def roofline_fraction_overlap(r: Dict) -> float:
    """Same metric against the perfect-overlap bound (max of terms)."""
    t = r["terms"]
    step = max(t["compute_s"], t["memory_s"], t["collective_s"])
    if step <= 0 or not r.get("model_flops"):
        return 0.0
    return r["model_flops"] / (t["n_chips"] * hw.PEAK_FLOPS_BF16 * step)


def render_table(results: List[Dict], mesh: str) -> str:
    rows = [r for r in results if r["mesh"] == mesh and r["ok"] and r.get("terms")]
    out = [
        "| arch | shape | compute | memory | collective | dominant | "
        "model/counted FLOPs | frac (sum) | frac (overlap) |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(rows, key=lambda x: (x["arch"], x["shape"])):
        t = r["terms"]
        ratio = r.get("flops_ratio", 0.0)
        out.append(
            f"| {r['arch']} | {r['shape']} | {_fmt_s(t['compute_s'])} | "
            f"{_fmt_s(t['memory_s'])} | {_fmt_s(t['collective_s'])} | "
            f"**{t['dominant']}** | {ratio:.2f} | {roofline_fraction(r):.3f} | "
            f"{roofline_fraction_overlap(r):.3f} |"
        )
    return "\n".join(out)


def render_memory_table(results: List[Dict], mesh: str) -> str:
    rows = [r for r in results if r["mesh"] == mesh and r["ok"] and r.get("memory")]
    cap = f"{hw.HBM_BYTES / 1e9:.0f} GB"
    out = [
        f"| arch | shape | args/card | temp/card | peak/card | fits H100 {cap} |",
        "|---|---|---|---|---|---|",
    ]
    for r in sorted(rows, key=lambda x: (x["arch"], x["shape"])):
        m = r["memory"]
        peak = r.get("peak_est") or m["peak_bytes"]
        fits = "yes" if peak <= hw.HBM_BYTES else "**NO**"
        out.append(
            f"| {r['arch']} | {r['shape']} | "
            f"{m['argument_bytes']/2**30:.2f}GiB | "
            f"{m['temp_bytes']/2**30:.2f}GiB | "
            f"{peak/2**30:.2f}GiB | {fits} |"
        )
    return "\n".join(out)


def summarize(path: str) -> None:
    with open(path) as f:
        results = json.load(f)
    meshes = sorted({r["mesh"] for r in results})
    ok = sum(r["ok"] for r in results)
    print(f"# {path}: {ok}/{len(results)} cells ok\n")
    for mesh in meshes:
        print(f"\n## roofline — mesh={mesh}\n")
        print(render_table(results, mesh))
        print(f"\n## memory — mesh={mesh}\n")
        print(render_memory_table(results, mesh))
    bad = [r for r in results if not r["ok"]]
    if bad:
        print("\n## FAILURES\n")
        for r in bad:
            print(f"- {r['arch']} x {r['shape']} ({r['mesh']}): {r['error']}")


if __name__ == "__main__":
    summarize(sys.argv[1])
