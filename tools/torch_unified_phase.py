#!/usr/bin/env python3
"""Phase ``unified``, ``unified_train`` or ``unified_variants`` of
chip_smoke.py alone, in a fresh process, on one card.

    python3 tools/torch_unified_phase.py              # stage-2 serving
    python3 tools/torch_unified_phase.py --train      # stage-2 training
    python3 tools/torch_unified_phase.py --variants   # phase 14

Runs the phase exactly as chip_smoke.py does (same inputs, gates and
prints), without the phases before it, so its host-side numbers
(scenes/s or steps/s, host seconds, device spans) can be set beside the
whole script's.
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
    args = sys.argv[1:]
    if "--variants" in args:
        name = "unified_variants"
        phase = chip_smoke.variants_phase
    elif "--train" in args:
        name = "unified_train"
        phase = lambda c, d: chip_smoke.unified_train_phase(c, d, None)  # noqa: E731
    else:
        name = "unified"
        phase = lambda c, d: chip_smoke.unified_phase(c, d, None)  # noqa: E731
    t0 = time.time()
    phase(card, torch.device("cuda"))
    print(f"{name} phase alone: {time.time() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
