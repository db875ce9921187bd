"""One run of one cell: the cell's files found by the names in
``BENCHMARK.json``, the runner its mix names, the per-layer readers, the
check of ``correct``, and the result line."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import sys
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
FORBIDDEN = ("jax", "jaxlib", "flax", "tce_rvos_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    config: Dict
    mix: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    limits: Dict[str, float]


def reports(metric: Dict, cell: str, e2e_names: List[str]) -> bool:
    """Whether ``cell`` reports ``metric``: its ``workloads`` list names the
    cell, or without one, the cell reports the end-to-end metric it moves
    (an end-to-end metric without the list: every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def load_cell(name: str, manifest: Optional[Dict] = None) -> Cell:
    m = manifest or json.loads((ROOT / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in m["workloads"]}
    if name not in work:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in m["configs"]}[w["config"]]
    config = json.loads((ROOT / conf["file"]).read_text())
    mix = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [x for x in m["end_to_end"] if reports(x, name, [])]
    names = [x["name"] for x in e2e]
    per_layer = [x for x in m["per_layer"] if reports(x, name, names)]
    limits = json.loads((BENCH / "limits" / f"{name}.json").read_text())["limits"]
    return Cell(name, config, mix, e2e, per_layer, limits)


def reader(metric: str):
    """The reader ``benchmark/metrics/<metric>.py``'s ``read(context)``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def runner(cell: Cell):
    """The ``run`` of the module ``benchmark/harness/<kind>.py`` that the
    mix's ``kind`` names: a new kind of traffic brings its own module."""
    return importlib.import_module(f"harness.{cell.mix['kind']}").run


def forbidden_modules() -> List[str]:
    return sorted({k.split(".")[0] for k in sys.modules} & set(FORBIDDEN))


def device_info(device, count: int, peak: int) -> Dict:
    import torch

    if torch.device(device).type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(), "count": count,
                "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": int(peak)}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> Dict:
    """Runs the cell once and returns the result line's object (the caller
    prints it); ``correct`` by the cell's limits."""
    from . import check

    res = runner(cell)(cell, seed, seconds, trace, device, t_start)
    if trace:
        ctx = res["context"]
        values = {}
        for m in cell.per_layer:
            v = reader(m["name"])(ctx)
            if v is not None:
                values[m["name"]] = {"value": float(v), "unit": m["unit"]}
        tr = ctx.trace
        dev = device_info(device, 1, res["peak"])
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        extra = {"breakdown": {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}}
    else:
        values = {m["name"]: {"value": float(res["e2e"][m["name"]]), "unit": m["unit"]}
                  for m in cell.end_to_end}
        dev = device_info(device, 1, res["peak"])
        extra = {}
    ok, shown = check.judge(res["numbers"], cell.limits)
    res.setdefault("notes", {})["readings"] = res["numbers"]
    ok = ok and all(math.isfinite(v["value"]) for v in values.values())
    return {"correct": bool(ok), "attempted": int(res["attempted"]), "failed": int(res["failed"]),
            "metrics": values, "device": dev, **extra, "notes": res.get("notes", {}),
            "compared": shown}
