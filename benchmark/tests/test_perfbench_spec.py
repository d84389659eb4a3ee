"""BENCHMARK.json keeps to its contract's shape and names, and the harness
finds every file a cell needs by the names it gives."""

import json
import re

import pytest

from core import guard, spec as specs

SPEC = specs.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert specs.check_names(SPEC) == []
    assert 1 <= SPEC["run_seconds"] <= 51
    for p in SPEC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/")
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_entries_have_just_their_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for cell in CELLS:
        names = [m["name"] for m in specs.cell_metrics(SPEC, cell, False)]
        assert "setup_s" in names and len(names) >= 2
        layers = specs.cell_metrics(SPEC, cell, True)
        assert layers
        for m in layers:
            assert m["moves"] in names, (cell, m["name"])


@pytest.mark.parametrize("cell", CELLS)
def test_the_harness_finds_every_file_of_a_cell(cell):
    for role, path in specs.files_of(SPEC, cell).items():
        assert path.exists(), (cell, role, path)
    assert (specs.BENCH_DIR / "limits" / f"{cell}.json").exists()
    for m in specs.cell_metrics(SPEC, cell, True):
        reader = specs.load_module("metrics", m["name"])
        assert callable(reader.read)


def test_layer_names_agree_letter_for_letter():
    by_layer = {}
    for m in SPEC["per_layer"]:
        by_layer.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values()), by_layer


def test_the_jax_check_compares_whole_top_level_names():
    assert guard.forbidden_modules(["med_tpu.x", "med_tpu", "jax.numpy", "flax"]) == [
        "flax", "jax.numpy", "med_tpu", "med_tpu.x"]
    assert guard.forbidden_modules(["med_tpu_torch.x", "med_tpu_torch", "jaxtyping",
                                    "torch"]) == []
