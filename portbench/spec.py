"""Find a cell's parts by the names in ``BENCHMARK.json``.

Everything that belongs to one configuration, traffic mix, per-layer
metric or system sits in a file of its own under ``portbench/``, named
after it: ``configs/<config>.json``, ``traffic/<traffic>.json``,
``limits/<workload>.json`` (the limits of its correctness numbers),
``metrics/<metric>.py`` (a reader) and ``systems/<system>.py`` (the
builder a configuration names).  A later cell, mix or metric is new files
and new entries, never an edit.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _name(s: str) -> str:
    if not isinstance(s, str) or not NAME.match(s):
        raise ValueError(f"not a benchmark name: {s!r}")
    return s


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"portbench: no {path}")
    return json.loads(path.read_text())


def load_module(path: Path, name: str):
    """The Python file ``path`` as a module (names may hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"portbench: no {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list            # BENCHMARK.json's entries this cell reports
    per_layer: list
    root: Path
    chips: int

    def system(self):
        """The builder module of the cell's configuration."""
        sys_name = _name(self.config["system"])
        return load_module(self.root / "portbench" / "systems"
                           / f"{sys_name}.py",
                           f"portbench.systems.{sys_name}")

    def reader(self, metric: str):
        return load_module(self.root / "portbench" / "metrics"
                           / f"{_name(metric)}.py",
                           f"portbench_metric_{metric.replace('.', '_')}")


def _reports(metric: dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def load(root: Path, workload: str) -> Cell:
    """Cell ``workload`` of ``root/BENCHMARK.json``, with its files."""
    root = Path(root)
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"portbench: no workload {workload!r} in "
                       f"BENCHMARK.json ({sorted(cells)})")
    w = cells[_name(workload)]
    base = root / "portbench"
    config = _json(base / "configs" / f"{_name(w['config'])}.json")
    traffic = _json(base / "traffic" / f"{_name(w['traffic'])}.json")
    limits = _json(base / "limits" / f"{workload}.json")
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, workload, names)]
    return Cell(workload, config, traffic, limits, e2e, per_layer, root,
                int(w["chips"]))
