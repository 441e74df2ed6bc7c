"""BENCHMARK.json against the benchmark's contract, and everything found
by name: every cell, configuration, traffic, entry and metric of the
committed file, and a cell, configuration, traffic and metric added as new
files in a copy."""
from __future__ import annotations

import ast
import json
import os
import re
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import tiny  # noqa: E402

REPO = tiny.REPO
sys.path.insert(0, REPO)
from perfbench import run  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head)"
                   r"|_dim$|_rank$|expansion|experts_per_tok")


def bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_keys_and_names():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "perfbench/run.py"]
    assert b["paths"] == ["perfbench"]
    assert 1 <= b["run_seconds"] <= 51
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    names += [w["name"] for w in b["workloads"]]
    names += [c["name"] for c in b["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    assert len(json.dumps(b)) <= 64 * 1024


def test_metrics_and_bounds():
    b = bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        layers.setdefault(m["layer"], []).append(m["name"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    cells = {w["name"] for w in b["workloads"]}
    for w in cells:
        reported = [m for m in b["end_to_end"]
                    if w in m.get("workloads", [w])]
        assert {m["name"] for m in reported} >= {"setup_s"}
        assert len(reported) >= 2
        assert any(w in m.get("workloads", [w]) for m in b["per_layer"])
    for m in b["per_layer"]:
        moved = e2e[m["moves"]]
        for w in m.get("workloads", cells):
            assert w in moved.get("workloads", [w])


def test_cells_configs_and_files_resolve():
    b = bench()
    confs = {c["name"]: c for c in b["configs"]}
    used = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        found = run.find_cell(REPO, w["name"])
        cell = found["cell"]
        assert cell["chips"] == w["chips"]
        assert os.path.exists(os.path.join(
            REPO, "perfbench", "entries", cell["entry"] + ".py"))
        for m in found["per_layer"]:
            assert os.path.exists(os.path.join(
                REPO, "perfbench", "metrics", m["name"] + ".py")), m
        assert cell["limits"], w["name"]
        used.add(w["config"])
    assert used == set(confs)
    files = [c["file"] for c in confs.values()]
    assert len(files) == len(set(files))
    for c in confs.values():
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
        with open(os.path.join(REPO, c["file"])) as f:
            conf = json.load(f)
        assert conf["name"] == c["name"]
        assert conf["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTH.search(key), key


def test_a_cell_added_as_files_is_found(tmp_path):
    root = tiny.tiny_root(str(tmp_path))
    found = run.find_cell(root, "tiny_serve")
    assert found["config"]["name"] == "tiny_instseg"
    assert found["traffic"]["scenes"] == 4
    assert found["cell"]["entry"] == "instseg_serve"
    assert {m["name"] for m in found["end_to_end"]} == {
        "serve_requests_per_s", "serve_p95_s", "peak_mem_gib", "setup_s"}
    # a per-layer metric added as a file and an entry
    with open(os.path.join(root, "perfbench", "metrics",
                           "tiny.steps.py"), "w") as f:
        f.write("def read(ctx):\n    return ctx.get('steps') or None\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        b = json.load(f)
    b["per_layer"].append({"name": "tiny.steps", "unit": "batches",
                           "better": "higher", "source": "program_counter",
                           "layer": "server (serve.py)",
                           "moves": "serve_requests_per_s",
                           "workloads": ["tiny_serve"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    found = run.find_cell(root, "tiny_serve")
    names = [m["name"] for m in found["per_layer"]]
    assert "tiny.steps" in names
    got = run.layer_metrics(root, [m for m in found["per_layer"]
                                   if m["name"] == "tiny.steps"],
                            {"steps": 7})
    assert got == {"tiny.steps": {"value": 7, "unit": "batches"}}
    # the committed cell is not affected by the new one
    assert "tiny.steps" not in [
        m["name"] for m in run.find_cell(root, "s1_serve_dev_maps")
        ["per_layer"]]


def test_an_unknown_cell_is_refused(tmp_path):
    with pytest.raises(KeyError):
        run.find_cell(REPO, "no_such_cell")


def test_metric_readers_give_nothing_on_an_empty_context():
    b = bench()
    for m in b["per_layer"]:
        mod = run.load_module(os.path.join(REPO, "perfbench", "metrics",
                                           m["name"] + ".py"), "m")
        assert mod.read({}) is None, m["name"]


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module


def test_no_module_under_perfbench_imports_jax_or_the_jax_package():
    seen = []
    for dirpath, _, files in os.walk(os.path.join(REPO, "perfbench")):
        for fn in files:
            if fn.endswith(".py"):
                for mod in _imports(os.path.join(dirpath, fn)):
                    seen.append(mod)
                    assert mod.split(".")[0] not in run.FORBIDDEN, \
                        (fn, mod)
    assert any(m.startswith("pq3d_tpu_torch") for m in seen)


def test_the_forbidden_module_check_compares_whole_top_level_names():
    assert run.forbidden_modules(["pq3d_tpu_torch", "pq3d_tpu_torch.serve",
                                  "jaxtyping", "flaxen", "numpy"]) == []
    assert run.forbidden_modules(["pq3d_tpu.ops.sparse", "jax",
                                  "jaxlib.xla_client", "flax.linen",
                                  "optax"]) == [
        "flax.linen", "jax", "jaxlib.xla_client", "optax",
        "pq3d_tpu.ops.sparse"]


def test_nothing_under_perfbench_reads_the_old_benchmark_files():
    here = os.path.abspath(__file__)
    for dirpath, _, files in os.walk(os.path.join(REPO, "perfbench")):
        for fn in files:
            path = os.path.join(dirpath, fn)
            if not fn.endswith((".py", ".json")) or path == here:
                continue
            with open(path) as f:
                text = f.read()
            assert "bench.py" not in text, path
            assert not re.search(r"[\"']tools/", text), path
            assert "chip_smoke" not in text or fn.endswith(".py"), path
            for mod in (_imports(path) if fn.endswith(".py") else []):
                assert mod.split(".")[0] not in ("chip_smoke", "tools",
                                                 "bench"), (path, mod)
