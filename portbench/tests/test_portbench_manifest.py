"""BENCHMARK.json against the benchmark's contract: names, units, files
that exist and load, metrics that move what their cells report, and a
cell added as a new file plus a new entry."""

from __future__ import annotations

import importlib
import json
import re
import shutil

import pytest

from portbench.tests.helpers import ROOT, harness

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
ALL_METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert all(_line(w) for w in BENCH["command"]) and len(BENCH["command"]) <= 32
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) and not p.startswith("/")
        assert ".." not in p.split("/")


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"] + ALL_METRICS,
                         ids=lambda e: e["name"])
def test_names(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert _line(entry[key])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")


def test_unique_names():
    for group in (BENCH["configs"], BENCH["workloads"], ALL_METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    data = json.loads((ROOT / cfg["file"]).read_text())
    assert data["name"] == cfg["name"]
    assert data["reduced"] == cfg["reduced"]
    assert len(cfg["reduced"]) <= 16
    widths = re.compile(r"(_size$|_dim$|_rank$|_channels$|^hidden|intermediate|latent|expand|"
                        r"experts_per|d_state|headdim|proj)")
    for key in cfg["reduced"]:
        assert NAME.match(key) and not widths.search(key), key
        assert key in data
    assert importlib.import_module(f"portbench.reference.{data['reference']}")
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_load(cell):
    _, entry, workload, config = harness.load_cell(cell["name"])
    assert entry["chips"] in (1, 4)
    assert importlib.import_module(f"portbench.drivers.{workload['driver']}").Cell
    for m in harness.cell_metrics(BENCH, cell["name"], False) + harness.cell_metrics(
            BENCH, cell["name"], True):
        assert callable(harness.reader(m["name"]).read)
    e2e = {m["name"] for m in harness.cell_metrics(BENCH, cell["name"], False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.cell_metrics(BENCH, cell["name"], True)


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_moves_what_its_cells_report(metric):
    moved = next(m for m in BENCH["end_to_end"] if m["name"] == metric["moves"])
    for cell in metric["workloads"]:
        assert cell in moved.get("workloads", [cell])
        assert any(w["name"] == cell for w in BENCH["workloads"])


def test_a_new_cell_needs_no_edit(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    new = "rwkv6-1.6b.train-4x2048"
    wl = json.loads((ROOT / "portbench/workloads/zamba2-7b-24l.train-8x2048.json").read_text())
    wl["traffic"]["batch"] = 4
    (tmp_path / "portbench/workloads" / f"{new}.json").write_text(json.dumps(wl))
    bench["workloads"].append({"name": new, "config": "rwkv6-1.6b", "traffic": "train-4x2048",
                               "chips": 1, "why": "a smaller batch"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "zamba2-7b-24l.train-8x2048" in m.get("workloads", []) and "flash" not in m["name"]:
            m["workloads"].append(new)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    b, entry, workload, _ = harness.load_cell(new, tmp_path)
    assert workload["traffic"]["batch"] == 4 and entry["chips"] == 1
    names = {m["name"] for m in harness.cell_metrics(b, new, True)}
    assert "scan_roofline.train" in names and "flash_roofline.train" not in names
