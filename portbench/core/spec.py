"""Finding a cell's parts by name.

``BENCHMARK.json`` at the root of the checkout names the cells. A cell's
configuration is the JSON file its ``configs`` entry names
(``portbench/configs/<config>.json``), its traffic mix is
``portbench/traffic/<traffic>.json``, its driver is
``portbench/drivers/<family>.py`` (``family`` is a key of the
configuration), the driver's task is the mix's ``task``, and each per-layer
metric is ``portbench/metrics/<metric>.py``. Adding a cell, a mix or a
metric adds files and entries; nothing here changes.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import pathlib
from typing import Any, Dict, List, Optional

ROOT = pathlib.Path(__file__).resolve().parents[2]    # the checkout


def load_json(path: pathlib.Path) -> Any:
    with open(path) as f:
        return json.load(f)


def benchmark(root: pathlib.Path = ROOT) -> Dict[str, Any]:
    return load_json(root / "BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its parts loaded."""

    name: str
    chips: int
    config: Dict[str, Any]
    mix: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]    # the metric entries it reports
    per_layer: List[Dict[str, Any]]


def _reports(metric: Dict[str, Any], cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in e2e_names


def config(name: str, bench: Dict[str, Any], root: pathlib.Path = ROOT
           ) -> Dict[str, Any]:
    entry = next((c for c in bench["configs"] if c["name"] == name), None)
    if entry is None:
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")
    return load_json(root / entry["file"])


def mix(name: str, root: pathlib.Path = ROOT) -> Dict[str, Any]:
    return load_json(root / "portbench" / "traffic" / f"{name}.json")


def cell(name: str, bench: Optional[Dict[str, Any]] = None,
         root: pathlib.Path = ROOT) -> Cell:
    bench = benchmark(root) if bench is None else bench
    w = next((w for w in bench["workloads"] if w["name"] == name), None)
    if w is None:
        known = ", ".join(x["name"] for x in bench["workloads"])
        raise KeyError(f"no workload {name!r} in BENCHMARK.json ({known})")
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, ())]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name, int(w["chips"]), config(w["config"], bench, root),
                mix(w["traffic"], root), e2e, layer)


def driver(cfg: Dict[str, Any]):
    """The driver module of the configuration's model family."""
    return importlib.import_module(f"portbench.drivers.{cfg['family']}")


def task(cfg: Dict[str, Any], traffic: Dict[str, Any]):
    """The driver class that runs the mix's task on the configuration."""
    mod = driver(cfg)
    try:
        return mod.TASKS[traffic["task"]]
    except KeyError:
        raise KeyError(f"driver {cfg['family']!r} has no task "
                       f"{traffic['task']!r}") from None


def metric_reader(name: str, root: pathlib.Path = ROOT):
    """``portbench/metrics/<name>.py``'s ``read``."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    modname = "portbench.metrics._" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
