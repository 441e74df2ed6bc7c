#!/usr/bin/env python3
"""Phases ``gather_stem`` (17) and ``reference_warm_start`` (18) of
chip_smoke.py alone, in a fresh process, on one card.

    python3 tools/torch_gather_phase.py [--only gather_stem|reference_warm_start]

Runs each phase exactly as chip_smoke.py does (same inputs, gates and
prints), without the phases before it; kernel B1 is built at its first
launch.
"""
import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", choices=("gather_stem",
                                       "reference_warm_start"))
    args = ap.parse_args()
    import warnings
    import torch
    # as chip_smoke.py: the trainer's synthetic scenes outgrow the YAML's
    # deep level caps, which pad those levels to buckets
    warnings.filterwarnings("ignore", message="level .* > configured cap")
    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is false")
    from pq3d_tpu_torch.ops import zrun_conv
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    t0 = time.time()
    if args.only != "reference_warm_start":
        chip_smoke.gather_stem_phase(card, torch.device("cuda"), zrun_conv)
        torch.cuda.empty_cache()
    if args.only != "gather_stem":
        chip_smoke.reference_warm_start_phase(card, zrun_conv)
    print(f"gather phases alone: {time.time() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
