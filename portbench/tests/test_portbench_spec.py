"""BENCHMARK.json against the benchmark's contract, and the harness finding
every configuration, mix, driver and metric by name."""

import json
import re
import shutil

import pytest

from portbench.core import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_entries():
    names = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced",
                                     "why"}),
                        ("workloads", {"name", "config", "traffic", "chips",
                                       "why"})):
        for e in BENCH[group]:
            assert set(e) == keys
            assert NAME.match(e["name"]) and e["name"] not in names
            names.add(e["name"])
            assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]
    metrics = set()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in metrics
        metrics.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] == 0.25


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads_by_name(name):
    c = spec.cell(name)
    assert c.chips == 1
    assert spec.task(c.config, c.mix).unit
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e          # every reader's metric is reported
        assert callable(spec.metric_reader(m["name"]))


def test_configs_reduce_nothing_and_name_their_files():
    files = set()
    for e in BENCH["configs"]:
        cfg = spec.load_json(spec.ROOT / e["file"])
        assert e["file"].startswith("portbench/") and e["file"] not in files
        files.add(e["file"])
        assert cfg["name"] == e["name"] and cfg["reduced"] == e["reduced"] == []
        assert cfg["precision"] == {"dtype": "float32", "tf32": False,
                                    "fast_dots": False}
        assert any(e["name"] == w["config"] for w in BENCH["workloads"])


def test_new_files_add_entries_without_edits(tmp_path):
    """A configuration, a mix and a metric added as files, with entries in
    BENCHMARK.json, are found; no existing file changes."""
    shutil.copytree(spec.ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    cfg = spec.load_json(spec.ROOT / "portbench/configs/vit_b16.json")
    cfg.update(name="vit_l16", hidden_size=1024, num_hidden_layers=24,
               num_attention_heads=16, intermediate_size=4096)
    (tmp_path / "portbench/configs/vit_l16.json").write_text(json.dumps(cfg))
    mix = spec.mix("explain_b32")
    mix.update(batch=128, pool_batches=2)
    (tmp_path / "portbench/traffic/explain_b128.json").write_text(
        json.dumps(mix))
    (tmp_path / "portbench/metrics/launches.maps.py").write_text(
        "def read(run):\n    return None\n")
    bench["configs"].append({"name": "vit_l16", "source": "x",
                             "file": "portbench/configs/vit_l16.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "vit_l16.explain_b128",
                               "config": "vit_l16", "traffic": "explain_b128",
                               "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "launches.maps", "unit": "1",
                               "better": "lower", "source": "program_counter",
                               "layer": "wrappers", "moves": "maps_per_s",
                               "workloads": ["vit_l16.explain_b128"]})
    bench["end_to_end"][0]["workloads"].append("vit_l16.explain_b128")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    c = spec.cell("vit_l16.explain_b128", root=tmp_path)
    assert c.config["hidden_size"] == 1024 and c.mix["batch"] == 128
    assert [m["name"] for m in c.per_layer] == ["launches.maps"]
    assert spec.metric_reader("launches.maps", root=tmp_path)(None) is None
    for old in BENCH["workloads"]:
        assert spec.cell(old["name"], root=tmp_path).config == \
            spec.cell(old["name"]).config
