"""Finds everything by name: ``BENCHMARK.json`` at the checkout's root,
``workloads/<cell>.json``, ``configs/<config>.json``, ``traffic/<mix>.json``
and the code of its kind ``traffic/<kind>.py``, and ``metrics/<metric>.py``
for each per-layer metric. Adding a cell, a configuration, a mix or a
metric adds files and entries and edits none."""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return read_json(os.path.join(root, "BENCHMARK.json"))


def _module(path: str):
    name = "port_bench._loaded." + os.path.relpath(path, HERE).replace(
        os.sep, "__").replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_files(name: str) -> tuple:
    """(cell, mix, config) of the cell ``name``."""
    cell = read_json(os.path.join(HERE, "workloads", f"{name}.json"))
    mix = read_json(os.path.join(HERE, "traffic", f"{cell['traffic']}.json"))
    config = read_json(os.path.join(HERE, "configs", f"{cell['config']}.json"))
    return cell, mix, config


def driver_class(kind: str):
    return _module(os.path.join(HERE, "traffic", f"{kind}.py")).Driver


def reader(metric: str):
    return _module(os.path.join(HERE, "metrics", f"{metric}.py")).read


def _in_cell(metric: dict, cell: str, reported=None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric["moves"] in reported


def end_to_end(bench: dict, cell: str) -> list:
    """The end-to-end metrics the cell reports."""
    return [m for m in bench["end_to_end"] if _in_cell(m, cell)]


def per_layer(bench: dict, cell: str) -> list:
    """The per-layer metrics read in the cell: those that list it, and
    those without a list whose end-to-end metric it reports."""
    reported = {m["name"] for m in end_to_end(bench, cell)}
    return [m for m in bench["per_layer"] if _in_cell(m, cell, reported)]
