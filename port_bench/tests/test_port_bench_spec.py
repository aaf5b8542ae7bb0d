"""BENCHMARK.json against the contract's characters and keys, and the
harness finding cells, configurations, traffic and readers by name."""

import json
import re
import shutil

import pytest

from port_bench import check, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark()


def _names():
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[kind]:
            yield kind, entry["name"]


@pytest.mark.parametrize("kind,name", list(_names()))
def test_names_use_allowed_characters(kind, name):
    assert NAME.match(name), (kind, name)


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if "bound" in metric:
        assert set(metric) <= {"name", "unit", "better", "bound", "source",
                               "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer",
                               "moves", "workloads"}
        e2e = {m["name"]: m for m in BENCH["end_to_end"]}
        assert metric["moves"] in e2e
        moved = e2e[metric["moves"]].get("workloads")
        for cell in metric["workloads"]:
            assert moved is None or cell in moved
        assert "\n" not in metric["layer"] and len(metric["layer"]) <= 200
        spec.reader(metric["name"])   # a reader file of its own
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")
    if "roofline" in metric["name"] or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    names = [m["name"] for m in BENCH["end_to_end"]]
    assert "setup_s" in names and len(names) <= 16


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_file_matches_entry(entry):
    cell = spec.load_cell(entry["name"])
    assert (cell.config_name, cell.traffic_name, cell.chips, cell.why) == (
        entry["config"], entry["traffic"], entry["chips"], entry["why"])
    assert len(entry["why"]) <= 200 and entry["chips"] in (1, 4)
    assert cell.limits and set(cell.limits) <= set(check.NUMBERS)
    conf = next(c for c in BENCH["configs"] if c["name"] == entry["config"])
    assert conf["file"] == f"port_bench/configs/{entry['config']}.json"
    assert conf["reduced"] == cell.config["reduced"]
    assert conf["source"] == cell.config["source"]
    for kind in ("end_to_end", "per_layer"):
        got = spec.cell_metrics(BENCH, entry["name"], kind == "per_layer")
        assert got, (kind, entry["name"])
    assert "setup_s" in {m.name for m in spec.cell_metrics(
        BENCH, entry["name"], False)}


def test_every_cell_file_is_listed():
    assert spec.cell_names() == sorted(w["name"] for w in BENCH["workloads"])


def test_new_workload_file_is_found_without_an_edit(tmp_path):
    root = tmp_path / "port_bench"
    shutil.copytree(spec.HERE, root,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    new = {"name": "gpt2m-blockq-b8x1024", "config": "gpt2-medium-bf16",
           "traffic": "lm-blockq-b8x1024", "chips": 1, "why": "a test cell",
           "limits": {"loss_gap": 1, "grad_gap": 1, "change_gap": 1}}
    traffic = json.loads((root / "traffic" / "lm-blockq-b16x1024.json")
                         .read_text())
    traffic["batch_per_rank"] = 8
    (root / "traffic" / "lm-blockq-b8x1024.json").write_text(
        json.dumps(traffic))
    (root / "workloads" / "gpt2m-blockq-b8x1024.json").write_text(
        json.dumps(new))
    assert "gpt2m-blockq-b8x1024" in spec.cell_names(root)
    cell = spec.load_cell("gpt2m-blockq-b8x1024", root)
    assert cell.traffic["batch_per_rank"] == 8 and cell.chips == 1
    for path, data in before.items():
        assert path.read_bytes() == data, path


def test_bad_names_and_mismatches_are_refused(tmp_path):
    with pytest.raises(spec.SpecError):
        spec.load_cell("no such/cell")
    with pytest.raises(spec.SpecError):
        spec.load_cell("not-a-cell")
    with pytest.raises(spec.SpecError):
        spec.reader("no.such.metric")
