"""``BENCHMARK.json`` and the files it names. A configuration's file is the
``file`` of its entry; a traffic mix is ``portbench/traffic/<traffic>.json``;
a cell's limits are ``portbench/limits/<cell>.json``; a metric's reader is
``portbench/metrics/<metric>.py`` with a ``read(run)`` function; the system
a configuration drives is ``portbench/systems/<system>.py``, named by the
configuration's ``system`` key (``search`` where it has none)."""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
REPO = BENCH_DIR.parent
MANIFEST = REPO / "BENCHMARK.json"
SYSTEMS = BENCH_DIR / "systems"
DEFAULT_SYSTEM = "search"
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def load(path: Path = MANIFEST) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def traffic_path(name: str) -> Path:
    return BENCH_DIR / "traffic" / f"{name}.json"


def limits_path(cell: str) -> Path:
    return BENCH_DIR / "limits" / f"{cell}.json"


def reader_path(metric: str) -> Path:
    return BENCH_DIR / "metrics" / f"{metric}.py"


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(manifest: dict, name: str) -> dict:
    """Everything a run of cell ``name`` reads: its entry, configuration,
    traffic, limits and metrics (end to end, per layer)."""
    entries = {w["name"]: w for w in manifest["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(entries)})")
    entry = entries[name]
    config_entry = {c["name"]: c for c in manifest["configs"]}[entry["config"]]
    e2e = [m for m in manifest["end_to_end"] if applies(m, name)]
    return {
        "entry": entry,
        "config": _json(REPO / config_entry["file"]),
        "traffic": _json(traffic_path(entry["traffic"])),
        "limits": _json(limits_path(name)),
        "end_to_end": e2e,
        "per_layer": [m for m in manifest["per_layer"] if applies(m, name)
                      and any(x["name"] == m["moves"] for x in e2e)],
    }


def reader(metric: str):
    """The ``read(run)`` function of a metric's reader file."""
    path = reader_path(metric)
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def system_path(name: str) -> Path:
    return SYSTEMS / f"{name}.py"


def system(config: dict):
    """The module of the system ``config`` drives, imported from its file
    under :data:`SYSTEMS` (as ``portbench_system_<name>``). Raises
    ``ValueError`` where no such file exists, before anything of a run is
    built."""
    name = config.get("system", DEFAULT_SYSTEM)
    path = system_path(name)
    if not isinstance(name, str) or not _NAME.match(name) or not path.is_file():
        have = sorted(p.stem for p in SYSTEMS.glob("*.py"))
        raise ValueError(f"configuration {config.get('name')!r} names the system {name!r}, which has no module "
                         f"{path} (have {have})")
    key = f"portbench_system_{name.replace('.', '_').replace('-', '_')}"
    spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    sys.modules[key] = module
    return module
