"""``BENCHMARK.json`` and the files it names, found by name.

A cell is an entry of the manifest's ``workloads``; its parameters are
``workloads/<cell>.json`` and its configuration the file the manifest's
``configs`` entry names. A per-layer metric's reader is
``metrics/<metric>.py``. Adding a cell, a configuration or a metric
adds files and manifest entries and edits nothing here.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
MANIFEST = REPO / "BENCHMARK.json"

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load(path: Optional[Path] = None) -> dict:
    with open(path or MANIFEST) as f:
        return json.load(f)


def _by_name(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in the manifest")


def cell(manifest: dict, name: str, root: Path = REPO) -> dict:
    """The cell ``name``: its manifest entry, ``workloads/<name>.json``
    under ``params`` and its configuration file under ``config_file``."""
    entry = _by_name(manifest["workloads"], name, "workload")
    params = json.loads((root / "ltflbench" / "workloads"
                         / f"{name}.json").read_text())
    if params.get("config") != entry["config"]:
        raise ValueError(f"{name}: workload file names config "
                         f"{params.get('config')!r}, the manifest "
                         f"{entry['config']!r}")
    conf = _by_name(manifest["configs"], entry["config"], "config")
    return {**entry, "params": params,
            "config_file": json.loads((root / conf["file"]).read_text())}


def metrics_for(manifest: dict, name: str, section: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics the cell reports: those
    whose ``workloads`` list it, or that have no such list."""
    return [m for m in manifest[section]
            if name in m.get("workloads", [name])]


def reader(metric: str, root: Path = REPO) -> ModuleType:
    """``metrics/<metric>.py`` as a module (metric names hold dots)."""
    path = root / "ltflbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "ltflbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_names(manifest: dict) -> List[str]:
    """Every breach of the manifest's rules on names and units."""
    bad = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = set()
        for e in manifest[section]:
            if not NAME_RE.match(e["name"]):
                bad.append(f"{section}: name {e['name']!r}")
            if e["name"] in seen:
                bad.append(f"{section}: {e['name']!r} twice")
            seen.add(e["name"])
            if "unit" in e and not UNIT_RE.match(e["unit"]):
                bad.append(f"{section}: unit {e['unit']!r}")
    for w in manifest["workloads"]:
        for key in ("config", "traffic"):
            if not NAME_RE.match(w[key]):
                bad.append(f"workload {w['name']}: {key} {w[key]!r}")
    for c in manifest["configs"]:
        for k in c["reduced"]:
            if not NAME_RE.match(k):
                bad.append(f"config {c['name']}: reduced key {k!r}")
    return bad


def metric_units(manifest: dict) -> Dict[str, str]:
    return {m["name"]: m["unit"]
            for s in ("end_to_end", "per_layer") for m in manifest[s]}
