#!/usr/bin/env python3
"""Phase ``swin_layouts`` (15) of chip_smoke.py alone, in a fresh process,
on one card.

    python3 tools/torch_swin_phase.py

Runs the phase exactly as chip_smoke.py does (same inputs, gates and
prints), without the phases before it; kernel B1 is built at its first
launch (dev_flat_zt).
"""
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402


def main():
    import torch
    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is false")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    t0 = time.time()
    chip_smoke.swin_layouts_phase(card, torch.device("cuda"))
    print(f"swin_layouts phase alone: {time.time() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
