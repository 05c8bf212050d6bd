"""``BENCHMARK.json`` against the files it names and the rules it keeps, and a
tiny run on the CPU that loads neither JAX nor the JAX package."""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import pytest

from benchmark.harness import cell

ROOT = cell.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_and_limits(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert manifest["command"] == ["python3", "benchmark/run.py"]
    assert manifest["paths"] == ["benchmark"]
    assert 1 <= manifest["run_seconds"] <= 51
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in manifest["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in manifest["per_layer"]:
        assert "bound" not in m and m["moves"] in e2e
    assert len(json.dumps(manifest)) < 64 * 1024


def test_names_and_units(manifest):
    names = [c["name"] for c in manifest["configs"]] + [w["name"] for w in manifest["workloads"]]
    names += [m["name"] for m in manifest["end_to_end"] + manifest["per_layer"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in manifest["workloads"]]:
        assert NAME.match(n), n
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    for w in manifest["workloads"]:
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]


def test_every_entry_resolves(manifest):
    bench = os.path.join(ROOT, "benchmark")
    configs = {c["name"] for c in manifest["configs"]}
    for c in manifest["configs"]:
        assert c["file"].startswith("benchmark/") and os.path.isfile(os.path.join(ROOT, c["file"]))
    for w in manifest["workloads"]:
        assert w["config"] in configs
        spec = cell.Spec(w["name"])
        assert os.path.isfile(os.path.join(bench, "traffic", w["traffic"] + ".json"))
        assert os.path.isfile(os.path.join(bench, "systems", spec.config["system"] + ".py"))
        for path in spec.readers.values():
            assert os.path.isfile(path), path
        limits = spec.workload["limits"]
        assert limits and set(limits) <= {"flip_margin", "flip_mass", "conf_gap",
                                          "nms_mismatch"}
        assert all(v >= 0 for v in limits.values())
    assert configs == {w["config"] for w in manifest["workloads"]}


def test_every_cell_reports_enough(manifest):
    for w in manifest["workloads"]:
        spec = cell.Spec(w["name"])
        e2e = {m["name"] for m in spec.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and spec.per_layer
    cells_reporting = {m["name"]: {w["name"] for w in manifest["workloads"]
                                   if w["name"] in m.get("workloads", [w["name"]])}
                       for m in manifest["end_to_end"]}
    for m in manifest["per_layer"]:
        for c in m.get("workloads", []):
            assert c in cells_reporting[m["moves"]], (m["name"], c)


def test_run_without_a_card_prints_nothing():
    if _has_card():
        pytest.skip("this host has a CUDA card")
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "vga-batch16",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""


def test_tiny_run_loads_no_jax(tiny_root):
    code = ("import sys, json; sys.path.insert(0, {root!r});"
            "from benchmark.harness import cell;"
            "out = cell.run('vga-batch16', 2**40 + 3, 0.5, False, 'cpu', root={tiny!r});"
            "print(json.dumps([out['correct'], cell.forbidden_modules()]))").format(
                root=ROOT, tiny=tiny_root)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, env=dict(os.environ, USE_FLAX="0"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    correct, loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert loaded == []


def _has_card() -> bool:
    import torch

    return torch.cuda.is_available()
