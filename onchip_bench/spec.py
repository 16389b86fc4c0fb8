"""Finding a cell's pieces by name.

``BENCHMARK.json`` names each cell's configuration and traffic mix; this module
turns those names into the files under ``onchip_bench/`` and refuses a cell whose
file is missing.  Nothing here knows a particular cell, configuration or metric:
a later change adds one as new files and new entries.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


class MissingPiece(LookupError):
    """A name in ``BENCHMARK.json`` (or on the command line) with no file behind it."""


@dataclasses.dataclass(frozen=True)
class Cell:
    """One entry of ``workloads`` with the files its names lead to."""

    name: str
    config: str
    chips: int
    conf: dict
    traffic: dict
    limits: dict
    end_to_end: tuple          # names of the end-to-end metrics this cell reports
    per_layer: tuple           # names of the per-layer metrics this cell reports
    units: dict                # metric name -> unit


def load_benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise MissingPiece(f"no BENCHMARK.json at {path}")
    return json.loads(path.read_text())


def _file(kind: str, name: str, suffix: str, bench: Path) -> Path:
    path = bench / kind / f"{name}{suffix}"
    if not path.is_file():
        raise MissingPiece(f"{kind[:-1] if kind.endswith('s') else kind} {name!r}: "
                           f"no file {path.relative_to(bench.parent)}")
    return path


def data(kind: str, name: str, bench: Path = BENCH) -> dict:
    """``<kind>/<name>.json`` as a dict."""
    return json.loads(_file(kind, name, ".json", bench).read_text())


def module(kind: str, name: str, bench: Path = BENCH) -> ModuleType:
    """``<kind>/<name>.py`` imported under a module name of its own (a name
    may hold dots and dashes, which a Python module name may not)."""
    path = _file(kind, name, ".py", bench)
    mod_name = f"onchip_bench.{kind}.{re.sub(r'[^0-9A-Za-z_]', '_', name)}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    mod_spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    sys.modules[mod_name] = mod
    try:
        mod_spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[mod_name]
        raise
    return mod


def _applies(metric: dict, cell_name: str, e2e_of_cell: Optional[set] = None) -> bool:
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    if e2e_of_cell is not None:               # a per-layer metric without a list
        return metric["moves"] in e2e_of_cell
    return True


def resolve(bench_json: dict, cell_name: str, bench: Path = BENCH) -> Cell:
    """The cell named ``cell_name``, with every file it needs read; raises
    ``MissingPiece`` for an unknown cell or a missing file."""
    entries = [w for w in bench_json["workloads"] if w["name"] == cell_name]
    if not entries:
        raise MissingPiece(f"no workload {cell_name!r} in BENCHMARK.json; there are "
                           f"{[w['name'] for w in bench_json['workloads']]}")
    w = entries[0]
    conf = data("configs", w["config"], bench)
    traffic = data("traffic", w["traffic"], bench)
    limits = data("limits", cell_name, bench)
    for kind in ("reference", "port", "work"):
        _file(kind, w["config"], ".py", bench)
    e2e = tuple(m["name"] for m in bench_json["end_to_end"] if _applies(m, cell_name))
    per_layer = tuple(m["name"] for m in bench_json["per_layer"]
                      if _applies(m, cell_name, set(e2e)))
    for name in e2e + per_layer:
        _file("metrics", name, ".py", bench)
    units = {m["name"]: m["unit"] for m in bench_json["end_to_end"] + bench_json["per_layer"]}
    return Cell(cell_name, w["config"], int(w["chips"]), conf, traffic, limits, e2e, per_layer,
                units)
