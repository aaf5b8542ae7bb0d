"""Find a cell, its configuration, its traffic and its metrics by name.

``BENCHMARK.json`` at the checkout's root lists the cells and metrics; each
cell's own file (``workloads/<cell>.json``) holds what the contract's entry
holds plus the limits of its comparison, its configuration's file and its
traffic's file hold the sizes, each metric's reader is
``metrics/<metric>.py``, and the configuration's ``model`` names its
family, ``families/<model>.py`` with its plain reference
``reference/<model>.py``.  A later change adds a cell, a metric or a model
family by adding such files and entries; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
MODEL = re.compile(r"^[A-Za-z_][A-Za-z0-9_]{0,63}$")   # a module's name


class SpecError(ValueError):
    """A cell, configuration, traffic mix or metric that cannot be run."""


def _load_json(path: Path) -> dict:
    try:
        return json.loads(path.read_text())
    except FileNotFoundError:
        raise SpecError(f"{path} is missing") from None


@dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    kind: str                   # "end_to_end" or "per_layer"
    workloads: "tuple[str, ...] | None" = None

    def reported_in(self, cell: str) -> bool:
        return self.workloads is None or cell in self.workloads


@dataclass(frozen=True)
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    why: str
    config: dict
    traffic: dict
    limits: dict


def benchmark(path: Path = BENCHMARK) -> dict:
    return _load_json(path)


def metrics(bench: dict) -> "list[Metric]":
    out = []
    for kind in ("end_to_end", "per_layer"):
        for m in bench.get(kind, ()):
            wl = m.get("workloads")
            out.append(Metric(m["name"], m["unit"], kind,
                              None if wl is None else tuple(wl)))
    return out


def cell_metrics(bench: dict, cell: str, trace: bool) -> "list[Metric]":
    """The metrics a run of ``cell`` prints: the end-to-end ones untraced,
    the per-layer ones traced."""
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in metrics(bench)
            if m.kind == kind and m.reported_in(cell)]


def load_cell(name: str, root: Path = HERE) -> Cell:
    """The cell ``name`` from ``workloads/<name>.json`` with its
    configuration and traffic files."""
    if not NAME.match(name):
        raise SpecError(f"bad cell name {name!r}")
    w = _load_json(root / "workloads" / f"{name}.json")
    config = _load_json(root / "configs" / f"{w['config']}.json")
    traffic = _load_json(root / "traffic" / f"{w['traffic']}.json")
    if traffic.get("model") != config.get("model"):
        raise SpecError(f"traffic {w['traffic']} is for model "
                        f"{traffic.get('model')!r}, configuration "
                        f"{w['config']} is a {config.get('model')!r}")
    check_family(config.get("model"), root)
    if traffic.get("world", 1) != w["chips"]:
        raise SpecError(f"traffic {w['traffic']} runs a world of "
                        f"{traffic.get('world', 1)}, the cell asks for "
                        f"{w['chips']} chips")
    return Cell(name, w["config"], w["traffic"], int(w["chips"]), w["why"],
                config, traffic, dict(w.get("limits", {})))


def cell_names(root: Path = HERE) -> "list[str]":
    return sorted(p.stem for p in (root / "workloads").glob("*.json"))


def check_family(model, root: Path = HERE) -> None:
    """Raises unless the model family ``model`` has both its files, its
    program side and its plain reference, naming those that are
    missing."""
    if not isinstance(model, str) or not MODEL.match(model):
        raise SpecError(f"bad model name {model!r}: a family is a module, "
                        "families/<model>.py")
    files = [root / "families" / f"{model}.py",
             root / "reference" / f"{model}.py"]
    missing = [str(p) for p in files if not p.exists()]
    if missing:
        raise SpecError(f"no model family {model!r}: "
                        f"{' and '.join(missing)} missing")


def family(model: str):
    """The program side of the model family ``model``,
    ``families/<model>.py`` (what it gives: ``families/__init__.py``)."""
    check_family(model)
    return importlib.import_module(f"{__package__}.families.{model}")


def reader(metric: str, root: Path = HERE):
    """The ``read(record) -> float | None`` of ``metrics/<metric>.py``."""
    path = root / "metrics" / f"{metric}.py"
    if not path.exists():
        raise SpecError(f"no reader {path} for metric {metric!r}")
    spec = importlib.util.spec_from_file_location(
        f"port_bench.metrics._{metric.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
