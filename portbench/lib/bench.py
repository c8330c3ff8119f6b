"""What a run reads, found by the names in ``BENCHMARK.json``.

- a cell (``workloads`` entry) names a configuration and a traffic mix;
- the configuration's file is the entry's ``file``;
- the mix is ``traffic/<traffic>.json`` and names its driver kind, whose
  code is ``drivers/<kind>.py``;
- a per-layer metric's reader is ``metrics/<name>.py``, or that of the
  name cut at its last ``.`` or ``-`` (one reader serves a split name);
- the limits of a cell's correctness check are ``limits/<cell>.json``;
- a configuration's ``family`` key names the code of its model family,
  ``families/<family>.py`` (``family``).

Nothing here branches on a name: a cell, configuration, family, mix or
metric is added by adding its files and its entry.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType

PKG = Path(__file__).resolve().parent.parent      # portbench/
ROOT = PKG.parent                                  # the checkout


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path) -> ModuleType:
    """Import a file of the harness by its path (its name may hold dots or
    dashes, which ``import`` does not take), once a process a file."""
    if not path.exists():
        raise FileNotFoundError(f"portbench: no file {path}")
    name = "portbench_" + re.sub(r"[^0-9A-Za-z_]", "_", f"{path.parent.name}_{path.stem}")
    mod = sys.modules.get(name)
    if mod is not None and mod.__file__ == str(path):
        return mod
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[name]
        raise
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict          # the configuration's file
    mix_name: str
    mix: dict             # the traffic mix's file
    limits: dict          # limits/<cell>.json ({} when the cell has none yet)
    end_to_end: list      # the end-to-end metric entries this cell reports
    per_layer: list       # the per-layer metric entries this cell reports


def reports(entry: dict, cell: str) -> bool:
    """Whether a metric entry applies to ``cell`` (no ``workloads`` key:
    every cell)."""
    return "workloads" not in entry or cell in entry["workloads"]


def find_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"portbench: no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    pkg = root / "portbench"
    limits_path = pkg / "limits" / f"{name}.json"
    e2e = [m for m in bench["end_to_end"] if reports(m, name)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if m["moves"] in moved and reports(m, name)]
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"],
                config=load_json(root / conf["file"]), mix_name=w["traffic"],
                mix=load_json(pkg / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(limits_path) if limits_path.exists() else {},
                end_to_end=e2e, per_layer=per_layer)


def driver(kind: str) -> ModuleType:
    return load_module(PKG / "drivers" / f"{kind}.py")


def family(name: str) -> ModuleType:
    """``families/<name>.py``: a model family's sizes, layer plans (which
    the driver, the check and the work counts read), seeded weights, port
    configuration and plain reference."""
    return load_module(PKG / "families" / f"{name}.py")


def reader(metric: str) -> ModuleType:
    """``metrics/<metric>.py``; for a name split by kind of cell (such as
    ``device.idle_share.serve-decode``) without a file of its own, the
    reader of the name cut at its last ``.`` or ``-``, and so on."""
    name = metric
    while not (PKG / "metrics" / f"{name}.py").exists():
        cut = max(name.rfind("."), name.rfind("-"))
        if cut <= 0:
            raise FileNotFoundError(f"portbench: no reader for {metric!r} in {PKG / 'metrics'}")
        name = name[:cut]
    return load_module(PKG / "metrics" / f"{name}.py")


def per_layer_values(cell: Cell, rec: dict, trace) -> dict:
    """The cell's per-layer metrics of a traced run: each reader is handed
    the driver's ``rec`` with the trace's summary under ``trace``; one that
    finds nothing to read leaves its metric out."""
    rec = dict(rec, trace=trace)
    out = {}
    for m in cell.per_layer:
        v = reader(m["name"]).read(rec)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out
