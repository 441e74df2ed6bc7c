#!/usr/bin/env python3
"""Phase ``unified`` of chip_smoke.py alone, in a fresh process, on one card.

    python3 tools/torch_unified_phase.py

Serves the full-width unified_tasks_sceneverse model exactly as the phase
does inside chip_smoke.py (same requests, gates and prints), without the
stage-1 phases before it, so the two runs' host-side numbers (scenes/s,
forward_decode seconds, the decode span) can be set side by side.
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
    chip_smoke.unified_phase(card, torch.device("cuda"), None)
    print(f"unified phase alone: {time.time() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
