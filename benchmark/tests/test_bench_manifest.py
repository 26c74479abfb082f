"""BENCHMARK.json against the benchmark's rules: names, units, the metrics'
layers, what each moves and where it is reported, and that every name
resolves to a file the harness finds by that name."""
import json
import math
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "benchmark"
MAN = json.loads((REPO / "BENCHMARK.json").read_text())

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
CELLS = [w["name"] for w in MAN["workloads"]]
METRICS = MAN["end_to_end"] + MAN["per_layer"]


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_limits():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
    cmd = MAN["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert cmd[1].startswith(tuple(p + "/" for p in MAN["paths"]))
    r = MAN["run_seconds"]
    assert isinstance(r, int) and 1 <= r <= 51
    # a full check of 24 cells fits into the driver's 43200 s
    assert (2 + 14 * 24) * (r + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(MAN).encode()) <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_unique_and_well_formed(section):
    names = [e["name"] for e in MAN[section]]
    assert len(names) == len(set(names))
    assert all(NAME.fullmatch(n) for n in names)


def test_configs():
    from benchmark import harness
    used = {w["config"] for w in MAN["workloads"]}
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in MAN["paths"]))
        cfg = json.loads((REPO / c["file"]).read_text())
        assert (BENCH / "kinds" / f"{cfg['kind']}.py").is_file()
        # its timed entry, `step` where it names none
        entry = harness.entry_file(cfg)
        assert entry.is_file() and entry.parent == BENCH / "entries"
        assert entry.stem == cfg.get("entry", "step")
        assert len(c["reduced"]) <= 16
        assert all(NAME.fullmatch(k) for k in c["reduced"])


def test_workloads():
    assert 1 <= len(CELLS) <= 24
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))
    configs = {c["name"] for c in MAN["configs"]}
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.fullmatch(w["traffic"]) and _line(w["why"])
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
    assert sum(w["chips"] == 4 for w in MAN["workloads"]) <= max(
        1, len(CELLS) // 4)


@pytest.mark.parametrize("m", METRICS, ids=[m["name"] for m in METRICS])
def test_metric(m):
    e2e = m in MAN["end_to_end"]
    keys = {"name", "unit", "better", "source"} | (
        {"bound"} if e2e else {"layer", "moves"})
    assert keys <= set(m) <= keys | {"workloads"}
    assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher")
    assert m["source"] in SOURCES
    assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    assert set(m.get("workloads", CELLS)) <= set(CELLS)
    if e2e:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert _line(m["layer"])
        moved = {e["name"]: e for e in MAN["end_to_end"]}
        assert m["moves"] in moved
        reports = set(moved[m["moves"]].get("workloads", CELLS))
        assert set(m.get("workloads", reports)) <= reports
    if "mfu" in m["name"] or m["name"].endswith("_roofline"):
        assert m["unit"] == "%"


def test_every_cell_reports_enough():
    e2e = {m["name"]: set(m.get("workloads", CELLS))
           for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"] == set(CELLS)
    for c in CELLS:
        assert sum(c in cells for n, cells in e2e.items()
                   if n != "setup_s") >= 1
        assert any(c in m.get("workloads", CELLS) for m in MAN["per_layer"])


def test_layers_named_alike():
    """Metrics of one layer name it letter for letter alike, and every
    layer has a section in PERF.md's list of layers."""
    layers = {m["layer"] for m in MAN["per_layer"]}
    perf = (REPO / "PERF.md").read_text()
    for layer in layers:
        assert f"**{layer}**" in perf, layer


def test_work_model_matches_the_programs():
    """The frozen conv_diff work equals `kernels.check.bound_ms` for
    conv_diff3d at 258³ and 34³."""
    from benchmark.work import least_seconds
    from waterlily_tpu_torch.kernels.check import bound_ms
    for n in (258, 34):
        ms, kind = bound_ms("conv_diff3d", (n, n, n))
        s, kind2 = least_seconds("conv_diff", (n, n, n))
        assert kind == kind2 and math.isclose(s * 1e3, ms, rel_tol=1e-12)
