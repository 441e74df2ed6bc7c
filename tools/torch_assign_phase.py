#!/usr/bin/env python3
"""Phases ``train`` (8) and ``assign`` (8b) of chip_smoke.py alone, in a
fresh process, on one card, plus traces of the train step.

    python3 tools/torch_assign_phase.py [--tree DIR] [--traces N]
                                        [--save-costs PATH]

Builds phase 8's trainer (full width, batch 4 of 70k-point scenes), runs
phase 8 as chip_smoke.py does (1 warm and 5 timed steps, 5 steps on one
batch, the same gates and prints), then phase 8b where the tree has it,
then traces N train steps on phase 8's batch (``profile_run``: the step's
host-clock ms, the card's busy ms and the idle share).  ``--tree`` runs
the chip_smoke.py and package of another checkout (an unpacked parent
commit, say), so two trees are compared in one call; a tree without
phase 8b runs the rest.  ``--save-costs`` writes phase 8b's set-loss
costs and valid rows (``np.savez``).  Ends with one JSON line of the
readings.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="checkout to run (default: this)")
    ap.add_argument("--traces", type=int, default=3)
    ap.add_argument("--save-costs", metavar="PATH",
                    help="write phase 8b's set-loss costs here (npz)")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import chip_smoke
    import shutil
    import warnings
    import torch
    warnings.filterwarnings("ignore", message="level .* > configured cap")
    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is false")
    import pq3d_tpu_torch
    from pq3d_tpu_torch.ops import zrun_conv
    if not pq3d_tpu_torch.__file__.startswith(tree):
        chip_smoke.fail(f"imported {pq3d_tpu_torch.__file__}, not {tree}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"{card} | tree {tree}", flush=True)
    _, bw_peak = chip_smoke.peaks_for(torch.cuda.get_device_name(0))
    exp_dir = tempfile.mkdtemp(prefix="pq3d_assign_")
    t0 = time.time()
    try:
        trainer = chip_smoke.smoke_trainer(exp_dir)
        warm = next(iter(trainer.train_data(99)))
        print(f"setup: trainer and one batch in {time.time() - t0:.1f} s",
              flush=True)
        t0 = time.time()
        tr = chip_smoke.train_phase(trainer, zrun_conv, warm, card)
        out = {"tree": tree, "card": card, "phase8_s": time.time() - t0,
               "steps_per_s": len(tr["steps"]) / tr["wall_s"],
               "device_ms": [s["device_ms"] for s in tr["steps"]],
               "host_s": tr["host_s"], "counts": tr["counts"]}
        if hasattr(chip_smoke, "assign_phase"):
            t0 = time.time()
            out["assign"] = chip_smoke.assign_phase(
                trainer, warm, card, bw_peak, save=args.save_costs)
            out["phase8b_s"] = time.time() - t0
        out["traces"] = []
        for i in range(args.traces):
            wall_ms, busy_ms = chip_smoke.profile_run(
                lambda: trainer.train_batch(warm), f"train step {i + 1}")
            out["traces"].append({"host_ms": wall_ms, "busy_ms": busy_ms,
                                  "idle": 1 - busy_ms / wall_ms})
    finally:
        shutil.rmtree(exp_dir, ignore_errors=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
