"""Every data file of the benchmark parses and names files that exist;
``BENCHMARK.json`` keeps to the shape its runs rely on."""

import importlib
import json
import re

import pytest

from conftest import ROOT

BENCH = ROOT / "bench_port"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("path", sorted(
    p.relative_to(ROOT).as_posix() for p in BENCH.rglob("*.json")))
def test_data_file_parses(path):
    assert isinstance(json.loads((ROOT / path).read_text()), dict)


def test_benchmark_keys_and_names():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["bench_port"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    assert all(UNIT.match(m["unit"])
               for m in b["end_to_end"] + b["per_layer"])
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    assert all(0.01 <= m["bound"] <= 0.25 for m in b["end_to_end"])


def test_cells_find_their_files():
    b = bench()
    configs = {c["name"]: c for c in b["configs"]}
    for cell in b["workloads"]:
        config = json.loads((ROOT / configs[cell["config"]]["file"])
                            .read_text())
        assert config["name"] == cell["config"]
        traffic = json.loads((BENCH / "traffic" /
                              f"{cell['traffic']}.json").read_text())
        importlib.import_module(f"bench_port.traffic.{traffic['driver']}")
        limits = json.loads((BENCH / "workloads" / f"{cell['name']}.json")
                            .read_text())["limits"]
        assert limits and all(v is not None and v >= 0
                              for v in limits.values())
        assert cell["chips"] == 1


def test_every_metric_has_a_reader_and_cells():
    from bench_port import harness

    b = bench()
    e2e = {m["name"] for m in b["end_to_end"]}
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
    for cell in cells:
        spec = harness.load_cell(cell, ROOT)
        assert spec["per_layer"], cell
        assert len(spec["end_to_end"]) >= 3, cell


def test_configs_state_their_precision():
    for path in (BENCH / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        assert cfg["compute_dtype"] in ("float32", "bfloat16")
        assert cfg["control"] in ("tf32", "fp8")
        assert cfg["light_height"] == 4 * cfg["env_rows"]
        assert cfg["light_width"] == 4 * cfg["env_cols"]
