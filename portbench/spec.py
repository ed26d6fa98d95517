"""What a run reads, found by name: the cell in `BENCHMARK.json`, its
configuration (`configs/<config>.json`), its traffic mix
(`traffic/<traffic>.json`), the limits of its correctness check
(`limits/<cell>.json`: each number's limit beside the readings it was set
from) and a reader per per-layer metric (`metrics/<metric>.py`, a
function `read(record)`). A new configuration, mix, cell or metric is
new files and new entries; nothing here changes."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass(frozen=True)
class Cell:
    name: str
    config: dict            # configs/<config>.json
    traffic: dict           # traffic/<traffic>.json
    limits: dict            # number compared -> its limit
    chips: int
    end_to_end: tuple       # BENCHMARK.json's metric entries this cell
    per_layer: tuple        # reports


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: Path = ROOT, here: Path = HERE) -> Cell:
    """The cell `name` of BENCHMARK.json with its files read; KeyError
    if BENCHMARK.json has no such cell."""
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    return Cell(
        name=name,
        config=load_json(here / "configs" / f"{w['config']}.json"),
        traffic=load_json(here / "traffic" / f"{w['traffic']}.json"),
        limits={k: v["limit"] for k, v in
                load_json(here / "limits" / f"{name}.json").items()},
        chips=int(w["chips"]),
        end_to_end=tuple(m for m in bench["end_to_end"]
                         if _applies(m, name)),
        per_layer=tuple(m for m in bench["per_layer"] if _applies(m, name)))


def metric_reader(name: str, here: Path = HERE):
    """`read(record)` of metrics/<name>.py."""
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(cell: Cell, record: dict, here: Path = HERE) -> dict:
    """{name: {"value", "unit"}} of the cell's per-layer metrics whose
    reader found something to read (a reader returns None otherwise)."""
    out = {}
    for m in cell.per_layer:
        value = metric_reader(m["name"], here)(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
