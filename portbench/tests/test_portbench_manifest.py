"""BENCHMARK.json against the contract's shapes, and every name it gives
found as a file of the harness."""

import re

import pytest

import portbench_tiny
from portbench_tiny import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
M = portbench_tiny.manifest()


def test_top_level_keys_and_command():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert M["command"] == ["python3", "portbench/run.py"]
    assert M["paths"] == ["portbench"]
    assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)
    runs = 2 + 14 * 24
    assert runs * (M["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_keys():
    names = []
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("portbench/")
        names.append(c["name"])
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        for key in ("name", "config", "traffic"):
            assert NAME.match(w[key]), w[key]
        names.append(w["name"])
    for group in ("end_to_end", "per_layer"):
        for m in M[group]:
            assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
            assert m["better"] in ("lower", "higher")
            names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    assert len(set(n for n in (c["name"] for c in M["configs"]))) == len(M["configs"])
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_end_to_end_bounds_and_setup():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


def _reports(metric, cell):
    return cell in metric.get("workloads", [cell])


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in M["workloads"]:
        e2e = [m["name"] for m in M["end_to_end"] if _reports(m, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(_reports(m, w["name"]) for m in M["per_layer"])


def test_each_per_layer_metric_moves_an_end_to_end_metric_its_cells_report():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    layers = {}
    for m in M["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert _reports(moved, cell), (m["name"], cell)
        layers.setdefault(m["layer"], set()).add(m["name"])
        assert (m["name"].endswith("_roofline") or ".".join(m["name"].split(".")[:1]).endswith(
            "_roofline")) <= (m["unit"] == "%")


@pytest.mark.parametrize("w", M["workloads"], ids=lambda w: w["name"])
def test_every_name_finds_its_files(w):
    from portbench.lib import traffic
    mix = traffic.load(w["traffic"])
    assert mix["kind"] in ("serve", "train")
    assert (ROOT / "portbench" / "limits" / f"{w['name']}.json").is_file()
    for m in M["per_layer"]:
        if _reports(m, w["name"]):
            assert (ROOT / "portbench" / "metrics" / f"{m['name'].split('.')[0]}.py").is_file()


def test_mfu_reported_beside_each_kernel_roofline():
    for m in M["per_layer"]:
        if m["name"].split(".")[0].endswith("_roofline"):
            assert any("mfu" in o["name"] and o["moves"] == m["moves"] for o in M["per_layer"])
