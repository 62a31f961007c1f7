"""BENCHMARK.json and the files it names: found by name, and within the contract."""

import json
import statistics

import pytest

from port_bench.harness import cell as C

BENCH = C.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"]
    assert BENCH["command"] == ["python3", "port_bench/run.py"]


@pytest.mark.parametrize("name", CELLS)
def test_cell_finds_its_files(name):
    cell = C.Cell(BENCH, name)
    assert cell.config["name"] == cell.workload["config"]
    assert cell.config["entry"] in ("sd_txt2img", "dpm_sample")
    assert cell.entry().Entry
    assert cell.readers(), "every cell reports a per-layer metric"
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2
    assert set(cell.limits) and all(isinstance(v, (int, float)) for v in cell.limits.values())


def test_every_metric_file_is_named_and_every_named_metric_has_one():
    named = {m["name"] for m in BENCH["per_layer"]}
    assert set(C.metric_files()) == named


def test_per_layer_entries():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(CELLS)
        for w in m["workloads"]:   # each cell it lists reports the metric it moves
            assert C.Cell(BENCH, w)._reports(e2e[m["moves"]])
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_configs_entries():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("port_bench/configs/")
        assert json.loads(open(C.ROOT / c["file"]).read())["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_workloads():
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(BENCH["workloads"])


def test_end_to_end_bounds():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")["bound"] <= 0.25


def test_run_seconds_fit_the_check_with_24_cells():
    rs = BENCH["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def _all_names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            yield e["name"]
    for w in BENCH["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in BENCH["configs"]:
        yield from c["reduced"]


def test_names_and_units_are_what_the_driver_takes():
    assert all(C.valid_name(n) for n in _all_names())
    assert all(C.valid_unit(m["unit"]) for m in BENCH["end_to_end"] + BENCH["per_layer"])
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(set(names)) == len(names)


@pytest.mark.parametrize("bad", ["tokens per second", "a,b", "a/b", "µs", "-lead", "", "x" * 65])
def test_bad_names_are_refused(bad):
    assert not C.valid_name(bad)


@pytest.mark.parametrize("bad", ["tokens per second", "µs", "", "x" * 17])
def test_bad_units_are_refused(bad):
    assert not C.valid_unit(bad)


def test_size():
    assert len((C.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_spread_is_pythons_quartiles():
    # the bound's rule reads spreads as statistics.quantiles(n=4), inclusive of neither end
    q1, _, q3 = statistics.quantiles([1.0, 2.0, 3.0, 4.0, 5.0, 6.0], n=4)
    assert (q1, q3) == (1.75, 5.25)
