"""The benchmark's declaration and its harness's rules, on the CPU.

    python -m pytest portbench/tests -q            (here)
    python -m pytest portbench/tests -m cuda -q    (on the card)
"""
from __future__ import annotations

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import flops, run

HERE = Path(run.__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return run.load_benchmark()


def test_names_units_and_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
        assert (run.ROOT / c["file"]).is_file() and c["file"].startswith("portbench/")
        raw = json.loads((run.ROOT / c["file"]).read_text())
        assert raw["reduced"] == c["reduced"] and raw["source"] and "assumed" in raw
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in names
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert (HERE / "cells" / f"{w['name']}.json").is_file()
    for section in ("end_to_end", "per_layer"):
        for m in bench[section]:
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
            if section == "end_to_end":
                assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
            else:
                assert (HERE / "metrics" / f"{m['name']}.py").is_file()
    every = [m["name"] for s in ("end_to_end", "per_layer") for m in bench[s]]
    assert len(every) == len(set(every))
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in bench["end_to_end"])
    assert len(json.dumps(bench)) < 64 * 1024


def test_every_moves_is_reported_where_listed(bench):
    for m in bench["per_layer"]:
        e2e = next(e for e in bench["end_to_end"] if e["name"] == m["moves"])
        for w in m["workloads"]:
            assert w in e2e.get("workloads", [w]), (m["name"], w)
    for w in bench["workloads"]:
        name = w["name"]
        assert len(run.cell_metrics(bench, name, "end_to_end")) >= 2  # setup_s and one more
        assert run.cell_metrics(bench, name, "per_layer")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_file_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        tops = {m.split(".", 1)[0] for m in _imports(path)}
        assert not tops & set(run.FORBIDDEN), path
        if "reference" in path.parts:
            assert tops <= {"__future__", "contextlib", "typing", "numpy", "torch",
                            "portbench"}, path
            assert "downgan_tpu_torch" not in tops


def test_module_check_compares_whole_top_level_names():
    mods = ["downgan_tpu_torch.serving", "jaxtyping", "jax.numpy", "optax", "downgan_tpu.cli",
            "flaxen"]
    assert run.forbidden_modules(mods) == ["downgan_tpu.cli", "jax.numpy", "optax"]


def _fake_card(monkeypatch, available=True, count=1):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: available)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda *a, **k: None)


ARGS = ["--workload", "generate.florida-rrdb", "--seed", "1", "--seconds", "1"]


def test_a_run_that_finds_no_card_fails(monkeypatch, capsys):
    _fake_card(monkeypatch, available=False, count=0)
    monkeypatch.setattr(run, "run_cell", lambda *a, **k: pytest.fail("ran without a card"))
    assert run.main(ARGS) != 0
    assert capsys.readouterr().out == ""


def test_a_run_with_jax_loaded_prints_no_result(monkeypatch, capsys):
    _fake_card(monkeypatch)
    monkeypatch.setattr(run, "run_cell", lambda *a, **k: {"correct": True, "checks": {}})
    monkeypatch.setitem(sys.modules, "jax", type(sys)("jax"))
    assert run.main(ARGS) == 3
    assert capsys.readouterr().out == ""
    monkeypatch.delitem(sys.modules, "jax")
    assert run.main(ARGS) == 0


def test_drb_formula_and_reference_flops_match_the_port_census():
    assert flops.drb_flops_per_sample(16, 16, 16) == 17_694_720
    from downgan_tpu_torch.utils.flops import train_flop_census

    base = run.prepare("train.florida-rrdb", 0, 0, False, "cpu",
                       overrides={"config": {"filters": 8, "num_res_blocks": 2,
                                             "hp": {"batch_size": 4}}})
    for schedule, reuse in (("reference", False), ("fused", True)):
        raw = dict(base.raw, hp={**base.raw["hp"], "schedule": schedule,
                                 "metrics_reuse_fake": reuse})
        config = run.program_config(raw, 0)
        census = train_flop_census(config, config.hp.critic_iterations
                                   if schedule == "reference" else 1)
        assert flops.reference_train_flops(raw) == pytest.approx(census["flops_per_step"],
                                                                 rel=1e-12)


def test_the_generate_rate_is_read_per_layer_over_the_whole_window():
    read = run.load_module("metrics", "gen_patches_per_s.loop").read
    out = run.Outcome(e2e={}, attempted=10, failed=0, peak_bytes=0, checks={},
                      window={"kind": "generate", "patches": 1500, "seconds": 2.5})
    assert read(out) == 600.0
    out.window = {"kind": "train", "calls": 3, "seconds": 2.5}
    assert read(out) is None


DUMMY_TRAFFIC = '''
from portbench.run import Outcome


def run(r):
    r.mark_setup_done()
    return Outcome(e2e={"dummy_rate": 2.0 * r.cell["factor"]}, attempted=1, failed=0,
                   peak_bytes=0, checks={"answer_gap": 0.0}, window={"n": r.raw["width"]})
'''
DUMMY_METRIC = '''
def read(out):
    return float(out.window["n"])
'''


def test_new_cells_configs_traffic_and_metrics_are_files_only(tmp_path):
    """A configuration, a cell, a traffic kind and a per-layer metric added
    as files and BENCHMARK.json entries only, in a copy of the benchmark."""
    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = run.load_benchmark()
    (root / "portbench/configs/dummy-cfg.json").write_text(json.dumps(
        {"source": "https://example.org", "assumed": {}, "reduced": [], "width": 3, "hp": {}}))
    (root / "portbench/cells/dummy.dummy-cfg.json").write_text(json.dumps(
        {"kind": "dummy", "factor": 5, "limits": {"answer_gap": 0.0}}))
    (root / "portbench/traffic/dummy.py").write_text(DUMMY_TRAFFIC)
    (root / "portbench/metrics/dummy_width.py").write_text(DUMMY_METRIC)
    bench["configs"].append({"name": "dummy-cfg", "source": "https://example.org",
                             "file": "portbench/configs/dummy-cfg.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "dummy.dummy-cfg", "config": "dummy-cfg",
                               "traffic": "dummy", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "dummy_rate", "unit": "1/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["dummy.dummy-cfg"]})
    bench["per_layer"].append({"name": "dummy_width", "unit": "1", "better": "higher",
                               "source": "program_counter", "layer": "test",
                               "moves": "dummy_rate", "workloads": ["dummy.dummy-cfg"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json; from portbench.run import run_cell; print(json.dumps("
            "[run_cell('dummy.dummy-cfg', 1, 1, t, 'cpu') for t in (False, True)]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(root)},
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    plain, traced = json.loads(out.stdout.splitlines()[-1])
    assert plain["correct"] and plain["metrics"]["dummy_rate"]["value"] == 10.0
    assert "setup_s" in plain["metrics"]
    assert traced["metrics"] == {"dummy_width": {"value": 3.0, "unit": "1"}}


def test_a_checkout_without_the_program_fails(tmp_path):
    """A directory with BENCHMARK.json and the files under paths alone."""
    root = tmp_path / "bare"
    shutil.copytree(HERE, root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(run.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "-m", "portbench.run", *ARGS], cwd=root,
                         capture_output=True, text=True, timeout=120,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(root)})
    assert out.returncode != 0 and out.stdout == ""
