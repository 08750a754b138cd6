"""The benchmark's registry, checks and result line, driven by data.

A cell is an entry of ``workloads`` in ``BENCHMARK.json`` at the checkout's
root. Everything that belongs to one configuration, traffic mix, cell or
metric is a file of its own, found by name:

* ``configs[].file`` — the configuration (model sizes, precision, source);
* ``perfbench/traffic/<traffic>.json`` — the mix's parameters; its ``kind``
  names the general driver that reads it (``perfbench/drivers/<kind>.py``);
* ``perfbench/limits/<cell>.json`` — the limits of the numbers compared;
* ``perfbench/metrics/<metric>.py`` — a per-layer metric's reader:
  ``read(record) -> float | None`` over what the traced run recorded.

So a later cell, configuration, mix or metric is new files and new entries
in ``BENCHMARK.json``, never an edit of a file here.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "cse_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    limits: dict
    end_to_end: list
    per_layer: list
    root: Path


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"perfbench: no workload {name!r} in BENCHMARK.json ({', '.join(sorted(work))})")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "perfbench" / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((root / "perfbench" / "limits" / f"{name}.json").read_text())
    return Cell(name, config, traffic, int(w["chips"]), limits,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)], root)


def driver(kind: str):
    """The traffic driver of a mix's ``kind``."""
    return importlib.import_module(f"perfbench.drivers.{kind}")


def reader(metric: str, root: Path = ROOT):
    """A per-layer metric's ``read`` function, from its own file."""
    path = root / "perfbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_per_layer(cell: Cell, record: dict) -> dict:
    """Each per-layer metric of the cell that its reader finds, with its unit."""
    out = {}
    for m in cell.per_layer:
        value = reader(m["name"], cell.root)(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


# ---------------------------------------------------------------- checks


def check(name: str, value: float, limit: float) -> dict:
    """One number compared: it passes when finite and at most its limit."""
    value = float(value)
    return {"name": name, "value": value, "limit": float(limit), "ok": math.isfinite(value) and value <= limit}


def judge(checks: list[dict]) -> bool:
    return bool(checks) and all(c["ok"] for c in checks)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX package's."""
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def result_line(correct, attempted, failed, metrics, device, checks, breakdown=None) -> str:
    """The run's one JSON line; the numbers compared come last."""
    line = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed), "metrics": metrics,
            "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    return json.dumps(line)


def print_checks(checks: list[dict]):
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} <= {c['limit']!r} {'ok' if c['ok'] else 'FAILED'}",
              file=sys.stderr, flush=True)
