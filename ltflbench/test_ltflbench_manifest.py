"""The manifest and the files it names: rules on names, units and sizes;
every cell, configuration and per-layer metric found by name; a new cell
picked up from new files and a manifest entry alone."""
import json
import shutil

import pytest

from ltflbench import manifest as mf

M = mf.load()
CELLS = [w["name"] for w in M["workloads"]]
PER_LAYER = [m["name"] for m in M["per_layer"]]
E2E = {m["name"]: m for m in M["end_to_end"]}
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source",
                       "workloads"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"}}
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "proj",
               "_dim", "_rank", "head", "expan", "per_tok", "d_model",
               "d_ff")


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(M)) <= 64 * 1024
    assert 1 <= len(M["command"]) <= 32
    assert all(not w.startswith("/") and ".." not in w
               for w in M["command"])
    assert M["paths"] == ["ltflbench"]


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entry_keys(section):
    required = KEYS[section] - {"workloads"}
    for e in M[section]:
        assert required <= set(e) <= KEYS[section], e["name"]


def test_names_and_units():
    assert mf.check_names(M) == []
    for m in M["end_to_end"] + M["per_layer"]:
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in M["end_to_end"]:
        assert m["source"] in ("device_trace", "host_clock")
        assert 0.01 <= m["bound"] <= 0.25


def test_texts_fit_one_line():
    texts = [e["why"] for s in ("configs", "workloads") for e in M[s]]
    texts += [m["layer"] for m in M["per_layer"]]
    texts += [c["source"] for c in M["configs"]]
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t, t


def test_run_seconds_fit_the_check_with_24_cells():
    rs = M["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_reduced_names_no_width():
    for c in M["configs"]:
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert not any(w in k for w in WIDTH_WORDS), k


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = mf.cell(M, name)
    assert cell["chips"] in (1, 4)
    assert cell["params"]["entry"] in ("datacenter", "edge")
    assert cell["config_file"]["name"] == cell["config"]
    assert set(cell["config_file"]["reduced"]) == set(
        next(c for c in M["configs"] if c["name"] == cell["config"])
        ["reduced"])
    assert cell["params"]["limits"]


@pytest.mark.parametrize("name", CELLS)
def test_cell_reports_what_the_contract_asks(name):
    e2e = [m["name"] for m in mf.metrics_for(M, name, "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = mf.metrics_for(M, name, "per_layer")
    assert layer
    for m in layer:        # each per-layer metric moves one the cell reports
        assert m["moves"] in e2e, (m["name"], m["moves"])


@pytest.mark.parametrize("metric", PER_LAYER)
def test_metric_reader_found_by_name(metric):
    mod = mf.reader(metric)
    assert callable(mod.read)
    assert mod.__doc__.startswith(metric + ":")


def test_every_config_used_and_files_distinct():
    used = {w["config"] for w in M["workloads"]}
    assert used == {c["name"] for c in M["configs"]}
    files = [c["file"] for c in M["configs"]]
    assert len(set(files)) == len(files)
    assert all(f.startswith("ltflbench/") for f in files)
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_new_cell_found_from_new_files_alone(tmp_path):
    shutil.copytree(mf.HERE, tmp_path / "ltflbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    manifest = json.loads(json.dumps(M))
    params = json.loads((mf.HERE / "workloads" /
                         "granite-8b.fl_128.json").read_text())
    params["seq_len"] = 512
    (tmp_path / "ltflbench" / "workloads" / "granite-8b.fl_512.json") \
        .write_text(json.dumps(params))
    manifest["workloads"].append(
        {"name": "granite-8b.fl_512", "config": "granite-8b-4l",
         "traffic": "fl_512", "chips": 1, "why": "a new mix"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "granite-8b.fl_128" in m.get("workloads", []):
            m["workloads"].append("granite-8b.fl_512")
    cell = mf.cell(manifest, "granite-8b.fl_512", root=tmp_path)
    assert cell["params"]["seq_len"] == 512
    assert cell["config_file"]["d_model"] == 4096
    names = {m["name"] for m in mf.metrics_for(manifest, "granite-8b.fl_512",
                                              "per_layer")}
    assert "quant_roofline.dc" in names
    assert mf.reader("quant_roofline.dc", root=tmp_path).PATTERNS
