"""``BENCHMARK.json`` and the files it names, resolved for one cell."""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _named(entries: list, name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"BENCHMARK.json has no {what} {name!r}")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


@dataclass
class Cell:
    """One entry of ``workloads``: its deployment, its traffic and the
    metrics it reports.  ``params`` is the configuration overlaid with
    the traffic file (a key of both, such as ``file_frames``, is the
    traffic's)."""

    name: str
    chips: int
    config: dict
    params: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def load_cell(name: str, root: str = ROOT) -> Cell:
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    entry = _named(bench["workloads"], name, "workload")
    config = load_json(os.path.join(root, _named(bench["configs"], entry["config"],
                                                 "config")["file"]))
    traffic = load_json(os.path.join(HERE, "workloads", f"{name}.json"))
    if traffic.get("traffic") != entry["traffic"]:
        raise ValueError(f"workloads/{name}.json is traffic {traffic.get('traffic')!r}, "
                         f"BENCHMARK.json says {entry['traffic']!r}")
    params = {**config, **traffic}
    per_layer = []
    for metric in bench["per_layer"]:
        if _applies(metric, name):
            spec = load_json(os.path.join(HERE, "metrics", f"{metric['name']}.json"))
            per_layer.append({**spec, **metric})
    return Cell(name=name, chips=int(entry["chips"]), config=config, params=params,
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
                per_layer=per_layer)


def cell_names(root: str = ROOT) -> list[str]:
    return [w["name"] for w in load_json(os.path.join(root, "BENCHMARK.json"))["workloads"]]
