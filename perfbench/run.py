"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Everything is found by name:
``BENCHMARK.json`` names the cell's configuration and traffic; the cell is
``perfbench/cells/<cell>.json`` (its entry, the entry's arguments and the
chips it needs), the configuration the file ``BENCHMARK.json`` gives it,
the traffic ``perfbench/traffic/<traffic>.json``, the entry
``perfbench/entries/<entry>.py`` and each per-layer metric
``perfbench/metrics/<metric>.py`` (its ``read(ctx)`` returns the value,
or None when the run gave it nothing to read).

With ``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics and the device's busy and window
seconds from the profiler.  The numbers compared with the plain reference
come last on the line and as the last lines of standard error.  The run
fails (exit 1, no line) without a card, or when JAX, Flax or the JAX
package is loaded once the window has closed.

On a card the run holds the host libraries' thread pools (OpenMP, MKL,
OpenBLAS, torch's own) to one thread each.

``--control bf16`` runs the cell with the port's bf16 serving cast, the
control that the comparison must refuse; the benchmark's own runs never
pass it.
"""
from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pq3d_tpu")
THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find_cell(root: str, name: str) -> Dict:
    """The workload ``name`` of ``root``'s BENCHMARK.json with its cell,
    configuration and traffic files read, and the metrics it reports."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    work = next((w for w in bench["workloads"] if w["name"] == name), None)
    if work is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == work["config"])
    cell = load_json(os.path.join(root, "perfbench", "cells", name + ".json"))
    if (cell["config"], cell["traffic"]) != (work["config"], work["traffic"]):
        raise ValueError(f"cell {name}: its file and BENCHMARK.json name "
                         f"another configuration or traffic")
    return {"work": work, "cell": cell,
            "config": load_json(os.path.join(root, conf["file"])),
            "traffic": load_json(os.path.join(
                root, "perfbench", "traffic", work["traffic"] + ".json")),
            "end_to_end": [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])],
            "per_layer": [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]}


def forbidden_modules(modules) -> List[str]:
    """Loaded modules whose whole top-level name is JAX's, Flax's,
    Optax's or the JAX package's."""
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


def layer_metrics(root: str, specs: List[Dict], ctx: Dict) -> Dict:
    out = {}
    for m in specs:
        mod = load_module(os.path.join(root, "perfbench", "metrics",
                                       m["name"] + ".py"),
                          "perfbench_metric_" + m["name"].replace(".", "_"))
        value = mod.read(ctx)
        if value is not None and math.isfinite(value):
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def verdict(found: Dict, compared: Dict) -> tuple:
    """(correct, {number: {value, limit}}) under the cell's limits."""
    limits = found["cell"]["limits"]
    shown, ok = {}, True
    for key, limit in limits.items():
        value = compared.get(key)
        shown[key] = {"value": value, "limit": limit}
        if value is None or not value <= limit:
            ok = False
    return ok, shown


def parse(argv: Optional[List[str]]):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("", "bf16"), default="")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None, root: str = ROOT,
         device: str = "cuda") -> int:
    """Run the cell; ``device="cpu"`` (tests only) skips the look for a
    card and runs the port on the host."""
    args = parse(argv)
    if device == "cuda":
        # one thread for every pool of the host's libraries: the server's
        # thread and the clients' callbacks do the host work, and idle
        # pool threads spinning beside them only move its speed
        for var in THREAD_VARS:
            os.environ[var] = "1"
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    build = os.path.join(root, "build")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(build, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(build, "triton"))
    found = find_cell(root, args.workload)
    import torch
    if device == "cuda":
        torch.set_num_threads(1)
    chips = found["cell"]["chips"]
    if device == "cuda":
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < chips:
            print(f"perfbench: the cell needs {chips} CUDA device(s); "
                  f"found {torch.cuda.device_count()}", file=sys.stderr)
            return 2
        name = torch.cuda.get_device_name(0)
    else:
        name = "cpu"
    if root not in sys.path:
        sys.path.insert(0, root)
    entry = load_module(os.path.join(root, "perfbench", "entries",
                                     found["cell"]["entry"] + ".py"),
                        "perfbench_entry_" + found["cell"]["entry"])
    ctx = {"cell": found["cell"], "config": found["config"],
           "traffic": found["traffic"], "seed": args.seed,
           "seconds": args.seconds, "trace": args.trace, "device": device,
           "device_name": name, "control": args.control,
           "t_start": T_START}
    res = entry.run(ctx)
    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"perfbench: modules of JAX or the JAX package are loaded: "
              f"{bad}", file=sys.stderr)
        return 1
    correct, shown = verdict(found, res["compared"])
    correct = correct and res["failed"] == 0 and not res["notes"]
    dev = {"platform": "gpu" if device == "cuda" else "cpu", "kind": name,
           "count": chips, "memory_peak_bytes": int(res["peak_bytes"])}
    if args.trace:
        lctx = res["layer_ctx"]
        metrics = layer_metrics(root, found["per_layer"], lctx)
        tr = lctx["trace"]
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        th = lctx["trace_host"]
        breakdown = {"device_ops": tr.top_ops(), "idle_gaps": th.idle_gaps()}
        print(f"perfbench: traced the device alone {tr.window_s:.3f} s: "
              f"{len(tr.device)} device intervals ({len(tr.kernels())} "
              f"kernels), forwards {lctx['traced_forwards']}; with the "
              f"host {th.window_s:.3f} s: busy {th.busy_s():.4f} s, "
              f"{len(th.host)} host operators, forwards "
              f"{len(lctx['host_forwards'])}, B1 kernels "
              f"{sum('zrun_conv' in d[0] for d in th.device)}, calls "
              f"{sum(h[0] == 'pq3d::zrun_conv' for h in th.host)}",
              file=sys.stderr)
    else:
        metrics = {m["name"]: {"value": res["e2e"][m["name"]],
                               "unit": m["unit"]}
                   for m in found["end_to_end"]}
    line = {"correct": correct, "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics, "device": dev}
    if args.trace:
        line["breakdown"] = breakdown
    line["compared"] = shown
    if res.get("diag"):
        print(f"perfbench: {res['diag']}", file=sys.stderr)
    if res.get("worst"):
        print(f"perfbench: the widest logit gap: {res['worst']}",
              file=sys.stderr)
    for note in res["notes"]:
        print(f"perfbench: {note}", file=sys.stderr)
    print(f"perfbench: failed requests {res['failed']} (limit 0)",
          file=sys.stderr)
    for key, v in shown.items():
        print(f"compared {key} {v['value']} limit {v['limit']}",
              file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
