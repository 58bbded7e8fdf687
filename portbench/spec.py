"""``BENCHMARK.json`` and the files its names lead to.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix; the harness finds, by name alone:

* ``portbench/configs/<config>.json``: the code and the decoder (the
  configuration's ``file``);
* ``portbench/traffic/<traffic>.json``: the sweep's command line (SNR,
  schedule flags, engine flags);
* ``portbench/workloads/<cell>.json``: the comparison that decides
  ``correct`` and its limits;
* ``portbench/metrics/<metric>.py`` for every per-layer metric: a reader
  with ``read(ctx) -> float | None``, None where the run holds nothing
  for it to read (the metric is then left out of the run's line).

A later cell, configuration, mix or metric is new files plus new entries
here, and no edit of a file already there.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    check: dict
    end_to_end: list  # the end-to-end metric entries
    per_layer: list  # the per-layer metric entries


def load_benchmark(root: pathlib.Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def resolve(bench: dict, cell_name: str, root: pathlib.Path = ROOT) -> Cell:
    """The cell named ``cell_name`` with every file it needs, read."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell_name not in cells:
        raise KeyError(f"no workload {cell_name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[cell_name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]

    def read(path: pathlib.Path) -> dict:
        with open(path) as f:
            return json.load(f)

    return Cell(
        name=cell_name, config_name=w["config"], traffic_name=w["traffic"], chips=w["chips"],
        config=read(root / cfg["file"]),
        traffic=read(HERE / "traffic" / f"{w['traffic']}.json"),
        check=read(HERE / "workloads" / f"{cell_name}.json"),
        end_to_end=bench["end_to_end"], per_layer=bench["per_layer"])


def metric_reader(name: str):
    """The ``read`` function of ``portbench/metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
