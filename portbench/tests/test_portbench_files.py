"""The benchmark's files: ``BENCHMARK.json`` within the limits of its format,
every configuration, traffic mix, metric reader and limits file found by
its name, and each configuration file equal to the system's preset with its
listed changes."""

import copy
import dataclasses
import importlib.util
import json
import re

import pytest

from portbench import run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = run.benchmark()


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert all(not w.startswith("/") and ".." not in w
               for w in BENCH["command"])


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"]
                         + BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda e: e["name"])
def test_names_units_and_texts(entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
        assert entry["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] \
                and "\t" not in entry[key]


def test_names_are_unique_and_cells_resolve():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (run.HERE / "traffic" / f"{w['traffic']}.json").exists()
        assert (run.HERE / "limits" / f"{w['name']}.json").exists()
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == configs


def test_every_cell_reports_what_it_must():
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in BENCH["end_to_end"]
               if run.applies(m, w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = [m for m in BENCH["per_layer"]
                 if run.applies(m, w["name"]) and m["moves"] in e2e]
        assert layer
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_readers_are_found_by_name(metric):
    assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    path = run.HERE / "metrics" / f"{metric['name']}.py"
    spec = importlib.util.spec_from_file_location("reader", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    assert callable(module.read)


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_is_the_preset_with_its_changes(conf):
    from keras_object_detection_torch import config as presets

    assert conf["file"].startswith("portbench/")
    data = run._json(run.ROOT / conf["file"])
    assert data["reduced"] == conf["reduced"] == []
    preset = getattr(presets, data["system_preset"].rsplit(".", 1)[1])()
    expected = json.loads(preset.to_json())
    for key, value in data["changed_from_preset"].items():
        section, field = key.split(".")
        expected[section][field] = value
    assert data["config"] == json.loads(json.dumps(expected))
    # the file loads as the system's Config, unchanged by the round trip
    cfg = presets.Config.from_json(json.dumps(data["config"]))
    assert json.loads(cfg.to_json()) == data["config"]


def test_traffic_and_limits_files():
    for w in BENCH["workloads"]:
        spec = run._json(run.HERE / "traffic" / f"{w['traffic']}.json")
        assert spec["kind"] in ("train", "serve")
        limits = run._json(run.HERE / "limits" / f"{w['name']}.json")
        # an exact comparison (a count of served boxes) has the limit 0
        assert limits and all(isinstance(v, (int, float)) and v >= 0
                              for v in limits.values())
