"""One cell of ``BENCHMARK.json``, once: set-up, warm-up, the measured
window, the comparison with the plain reference, and the metrics.

Everything that belongs to one configuration, traffic mix, program,
graph generator or metric is found by its name under ``root``
(``configs/``, ``traffic/``, ``programs/``, ``generators/``,
``metrics/``), so a cell is added with files and entries alone.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from . import devtrace, graphs, mixes, parts
from .record import RunRecord

__all__ = ["Cell", "load_cell", "run_cell", "forbidden_modules", "FORBIDDEN"]

#: top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    read: Callable[[RunRecord], Optional[float]]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[Metric]
    per_layer: List[Metric]


def _reader(root: Path, name: str) -> Callable:
    """``metrics/<name>.py``, or for a quantity split by cells
    (``<quantity>.<split>``) the quantity's own ``metrics/<quantity>.py``."""
    quantity = name.split(".")[0]
    if not parts.path(root, "metrics", name).is_file():
        name = quantity
    return parts.load(root, "metrics", name).read


def _metrics(root: Path, entries: list, cell: str) -> List[Metric]:
    return [Metric(m["name"], m["unit"], _reader(root, m["name"]))
            for m in entries if cell in m.get("workloads", [cell])]


def load_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"have {sorted(cells)}")
    w = cells[name]
    config = next(c for c in spec["configs"] if c["name"] == w["config"])
    return Cell(
        name=name, chips=int(w["chips"]),
        config=json.loads((root / config["file"]).read_text()),
        traffic=json.loads(
            (root / "perfbench" / "traffic" / f"{w['traffic']}.json").read_text()),
        end_to_end=_metrics(root, spec["end_to_end"], name),
        per_layer=_metrics(root, spec["per_layer"], name))


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is forbidden, by whole name."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _open_engine(graph, store: str, engine_cfg: dict, device):
    """``VSWEngine.from_graph`` and the seconds of its preprocessing and
    store write (its wall time less the engine's own construction)."""
    from repro_torch.core import VSWEngine

    class Timed(VSWEngine):
        def __init__(self, *args, **kwargs):
            t0 = time.perf_counter()
            super().__init__(*args, **kwargs)
            self.open_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    engine = Timed.from_graph(graph, store, device=device, **engine_cfg)
    return engine, time.perf_counter() - t0 - engine.open_s


def _finite(x: float) -> float:
    """``x``, or the largest float where it is not finite (JSON has no
    infinity)."""
    return x if math.isfinite(x) else sys.float_info.max


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool, *,
             t_start: float, device="cuda", control: bool = False,
             log: Callable[[str], None] = lambda line: None) -> dict:
    """Run cell ``name`` once; the result object of the benchmark's line.

    ``control``: also compare the reference's control in the program's
    place (key ``control``); the benchmark's own runs leave it off.
    ``log`` receives a line for each phase of the set-up, with its seconds.
    """
    from repro_torch.core import Graph

    device = torch.device(device)
    cell = load_cell(root, name)
    on_card = device.type == "cuda"
    if on_card:
        from repro_torch.kernels import build

        build.library("spmv_ell")  # the only library the engine's path runs
    log(f"init and kernels {time.perf_counter() - t_start:.3f} s")

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    src, dst, perm = graphs.make(cell.config, gen, device, root)
    n = perm.numel()
    counts = graphs.counts_of(n, src, dst)
    mix = mixes.make(cell.traffic, src, perm, gen, root)
    src_host = src.to(torch.int32).cpu().numpy()
    dst_host = dst.to(torch.int32).cpu().numpy()
    del src, dst, perm
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    log(f"graph {time.perf_counter() - t_start:.3f} s: {counts}")

    with tempfile.TemporaryDirectory(prefix="perfbench-store-") as tmp:
        engine, preprocess_s = _open_engine(
            Graph(n, src_host, dst_host), tmp + "/store", cell.config["engine"],
            device)
        store_bytes = sum(f.stat().st_size for f in Path(tmp).rglob("*")
                          if f.is_file())
        log(f"preprocess and store {preprocess_s:.3f} s ({store_bytes} B), "
            f"engine open {engine.open_s:.3f} s")
        try:
            t0 = time.perf_counter()
            mix.warm_up(engine)
            log(f"warm-up {time.perf_counter() - t0:.3f} s")
            answers: List[mixes.Answer] = []
            iters: list = []
            with devtrace.capture(trace, device) as cap:
                t0 = time.perf_counter()
                setup_s = t0 - t_start
                while True:
                    answer, result = mix.request(engine, len(answers))
                    answers.append(answer)
                    iters.extend(result.iterations)
                    if time.perf_counter() - t0 >= seconds:
                        break
                window_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated(device) if on_card else 0
        finally:
            engine.close()
        del engine
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

    log(f"window {window_s:.3f} s, {len(answers)} requests, {len(iters)} "
        f"iterations; peak {peak} B")
    t0 = time.perf_counter()
    src = torch.from_numpy(src_host).to(device=device, dtype=torch.int64)
    dst = torch.from_numpy(dst_host).to(device=device, dtype=torch.int64)
    compared = mix.compare(answers, src, dst, n)
    log(f"reference {time.perf_counter() - t0:.3f} s")
    record = RunRecord(setup_s=setup_s, preprocess_s=preprocess_s,
                       window_s=window_s, requests=len(answers),
                       converged=sum(a.converged for a in answers),
                       iters=iters, counts=counts, trace=cap.trace)
    metrics: Dict[str, dict] = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = m.read(record)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": all(c.ok for c in compared), "attempted": len(answers),
           "failed": max(c.failed for c in compared), "metrics": metrics,
           "device": dev}
    if cap.trace is not None:
        dev["busy_s"] = cap.trace.busy_s
        dev["window_s"] = cap.trace.window_s
        out["breakdown"] = cap.trace.breakdown()
    if control:
        out["control"] = {c.name: c.value
                          for c in mix.compare(answers, src, dst, n, control=True)}
    out["compared"] = {c.name: {"value": _finite(c.value), "limit": c.limit}
                       for c in compared}
    return out
