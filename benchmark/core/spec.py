"""``BENCHMARK.json`` and the files it names.

Layout under ``benchmark/`` (each found by a name, none edited to add
another):

- ``configs/<config>.json``: a configuration's sizes (``file`` in
  ``BENCHMARK.json``), and ``reference/<config>.py`` its plain reference;
- ``traffic/<traffic>.json``: a traffic mix's parameters; its ``driver``
  names ``drivers/<driver>.py``, the general code that builds the system
  under test, makes the mix's inputs from the seed and drives the window;
- ``metrics/<metric>.py``: how one per-layer metric is read from a traced
  run (a ``read(run)`` function, and the program functions whose calls
  its spans wrap, ``SPANS``).
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
SPEC_FILE = ROOT / "BENCHMARK.json"

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_spec(path: Path = SPEC_FILE) -> dict:
    with open(path) as f:
        return json.load(f)


def check_names(spec: dict) -> List[str]:
    """Every breach of the naming rules: names, configs, traffic and reduced
    keys; units; one-line text fields; unique names."""
    errors = []

    def name(kind, value):
        if not isinstance(value, str) or not NAME.match(value):
            errors.append(f"{kind} {value!r} is not a name")

    def text(kind, value):
        if (not isinstance(value, str) or not 1 <= len(value) <= 200
                or "\n" in value or "\t" in value):
            errors.append(f"{kind} {value!r} is not one line of 1 to 200 characters")

    for c in spec["configs"]:
        name("config", c["name"])
        text("source", c["source"])
        text("why", c["why"])
        for key in c["reduced"]:
            name("reduced key", key)
    for w in spec["workloads"]:
        name("workload", w["name"])
        name("config", w["config"])
        name("traffic", w["traffic"])
        text("why", w["why"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        name("metric", m["name"])
        if not UNIT.match(m["unit"]):
            errors.append(f"unit {m['unit']!r} of {m['name']}")
        if "layer" in m:
            text("layer", m["layer"])
    for word in spec["command"]:
        text("command word", word)
    for kind, items in (("config", spec["configs"]), ("workload", spec["workloads"]),
                        ("metric", spec["end_to_end"] + spec["per_layer"])):
        names = [i["name"] for i in items]
        if len(set(names)) != len(names):
            errors.append(f"{kind} names repeat")
    return errors


def workload(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json; have "
                     f"{[w['name'] for w in spec['workloads']]}")


def config_entry(spec: dict, name: str) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            return c
    raise SystemExit(f"no configuration {name!r} in BENCHMARK.json")


def load_json(relative: str) -> dict:
    with open(ROOT / relative) as f:
        return json.load(f)


def load_config(spec: dict, name: str) -> dict:
    return load_json(config_entry(spec, name)["file"])


def load_traffic(name: str) -> dict:
    return load_json(f"benchmark/traffic/{name}.json")


def check_traffic(traffic: dict, allowed: dict) -> None:
    """Refuse a traffic file that holds a parameter its driver does not
    read: ``allowed`` maps each top-level key to None or to the keys of its
    nested group."""
    unknown = [k for k in traffic if k not in allowed and k not in ("driver", "why")]
    for key, inner in allowed.items():
        if inner is not None and isinstance(traffic.get(key), dict):
            unknown += [f"{key}.{k}" for k in traffic[key] if k not in inner]
    if unknown:
        raise SystemExit(f"traffic for {traffic['driver']} holds what it does not read: "
                         f"{unknown}")


def load_module(kind: str, name: str) -> ModuleType:
    """``benchmark/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = BENCH_DIR / kind / f"{name}.py"
    if not path.exists():
        raise SystemExit(f"{path.relative_to(ROOT)} is missing")
    key = f"bench_{kind}_{name.replace('.', '_').replace('-', '_')}"
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[key] = module
    spec.loader.exec_module(module)
    return module


def cell_metrics(spec: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: the end-to-end ones without a
    trace, the per-layer ones with it; a metric with ``workloads`` only in
    the cells it lists."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def files_of(spec: dict, cell: str) -> Dict[str, Path]:
    """Every file the harness looks up for ``cell``, by role."""
    w = workload(spec, cell)
    traffic = load_traffic(w["traffic"])
    out = {"config": ROOT / config_entry(spec, w["config"])["file"],
           "reference": BENCH_DIR / "reference" / f"{w['config']}.py",
           "traffic": BENCH_DIR / "traffic" / f"{w['traffic']}.json",
           "driver": BENCH_DIR / "drivers" / f"{traffic['driver']}.py"}
    for m in cell_metrics(spec, cell, True):
        out[f"metric {m['name']}"] = BENCH_DIR / "metrics" / f"{m['name']}.py"
    return out
