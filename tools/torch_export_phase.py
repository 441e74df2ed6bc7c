#!/usr/bin/env python3
"""Phase ``export`` (19) of chip_smoke.py alone, in a fresh process, on one
card.

    python3 tools/torch_export_phase.py

Runs the phase as chip_smoke.py does (same inputs, gates and prints),
without the phases before it: its exports (``chip_smoke.export_prepare``),
which the script makes beside phase 13's launches, are made here first,
then its card part; kernel B1 is built at its first launch.
"""
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402


def main():
    import json
    import warnings
    import torch
    # as chip_smoke.py: the slice's scenes outgrow the YAML's deep level
    # caps, which pad those levels to buckets
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
    out = chip_smoke.export_phase(card, torch.device("cuda"), zrun_conv)
    print(json.dumps(out), flush=True)
    print(f"export phase alone: {time.time() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
