"""Finds a cell's pieces by the names in ``BENCHMARK.json``: its
configuration (``configs/<name>.json``), its traffic mix
(``traffic/<name>.json``), its limits (``limits/<cell>.json``), its
reference model (``reference/models/<model>.py``) and the reader of each
per-layer metric (``metrics/<name>.py``, else ``metrics/<stem>.py`` where
the stem is the name up to its first dot). A new cell, configuration,
traffic mix or metric is a new file; no code here names one."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]       # the metrics this cell reports untraced
    per_layer: List[dict]        # and traced
    root: Path = ROOT            # the checkout its files are in

    @property
    def kind(self) -> str:
        """"grad" when the traffic's entry returns a gradient, else
        "value"."""
        return "grad" if "grad" in self.traffic["entry"] else "value"


def read_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(path: Path) -> ModuleType:
    """The Python file ``path`` as a module named after its file."""
    spec = importlib.util.spec_from_file_location(
        "phylo_bench_" + path.stem.replace(".", "_"), path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _reports(metric: dict, cell: str, workload_names: List[str]) -> bool:
    return cell in metric.get("workloads", workload_names)


def find_cell(name: str, bench: Optional[dict] = None,
              root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (or of ``bench``) with its
    files read."""
    bench = bench if bench is not None else read_json(root / "BENCHMARK.json")
    names = [w["name"] for w in bench["workloads"]]
    if name not in names:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"there are {names}")
    work = bench["workloads"][names.index(name)]
    here = root / "phylo_bench"
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, names)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if m["moves"] in reported and _reports(m, name, names)]
    return Cell(
        name=name,
        chips=work["chips"],
        config=read_json(here / "configs" / f"{work['config']}.json"),
        traffic=read_json(here / "traffic" / f"{work['traffic']}.json"),
        limits=read_json(here / "limits" / f"{name}.json"),
        end_to_end=e2e,
        per_layer=layer,
        root=root,
    )


def reference_model(config: dict, root: Path = ROOT) -> ModuleType:
    """The reference's model module named by the configuration."""
    return load_module(root / "phylo_bench" / "reference" / "models"
                       / f"{config['model']}.py")


def metric_reader(name: str, root: Path = ROOT) -> ModuleType:
    """The reader of per-layer metric ``name``."""
    folder = root / "phylo_bench" / "metrics"
    path = folder / f"{name}.py"
    if not path.exists():
        path = folder / f"{name.split('.')[0]}.py"
    return load_module(path)
