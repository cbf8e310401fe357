"""The manifest (`BENCHMARK.json`) against the benchmark's contract, and
every name in it found as a file."""

import json
import re

import pytest

from voxbench import harness

BENCH = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH).encode()) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) and not p.startswith("/") and ".." not in p
                                                  for p in BENCH["paths"])
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(1 <= len(w) <= 200 and "\n" not in w and "\t" not in w for w in BENCH["command"])


def test_names_and_units_use_allowed_characters():
    names = [c["name"] for c in BENCH["configs"]] + CELLS
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["config"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    for group in (BENCH["configs"], BENCH["workloads"], metrics):
        assert len({x["name"] for x in group}) == len(group)
    for text in [c["why"] for c in BENCH["configs"] + BENCH["workloads"]] + [m["layer"] for m in BENCH["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_entries_have_exactly_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_budget_of_a_full_check_fits():
    s = BENCH["run_seconds"]
    assert 1 <= s <= 51
    full = 24
    assert (2 + 14 * full) * (s + 60) + full * 2 * 90 + 1200 <= 43200
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_are_found_by_name(cell):
    c = harness.find_cell(cell)
    assert (harness.BENCH_DIR / "drivers" / f"{c.driver_name}.py").is_file()
    assert (harness.ROOT / c.config["world"]["file"]).is_file()
    for m in c.per_layer:
        assert hasattr(harness.metric_reader(m["name"]), "read")
    assert harness.driver_module(c.driver_name).Driver


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(cell):
    c = harness.find_cell(cell)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e, (m["name"], m["moves"])


def test_configs_name_their_world_and_reduce_nothing():
    for cfg in BENCH["configs"]:
        data = harness.load_json(harness.ROOT / cfg["file"])
        assert cfg["file"].startswith("voxbench/") and cfg["reduced"] == data["reduced"] == []
        assert data["source"] == cfg["source"] and data["assumed"]
        path = harness.ROOT / data["world"]["file"]
        assert path.stat().st_size == data["world"]["bytes"]
        from voxbench import world

        world.verify(path, data["world"])
        golden = data.get("light_golden")
        if golden is not None:
            assert (harness.ROOT / golden["file"]).stat().st_size == golden["bytes"]
            world.verify(harness.ROOT / golden["file"], golden)


def test_every_config_is_used_and_every_metric_file_is_listed():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    listed = {m["name"] for m in BENCH["per_layer"]}
    files = {p.name[:-3] for p in (harness.BENCH_DIR / "metrics").glob("*.py")}
    assert listed <= files
