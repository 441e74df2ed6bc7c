#!/usr/bin/env python3
"""Phase ``unified`` (or ``unified_train``) of chip_smoke.py alone, in a
fresh process, on one card.

    python3 tools/torch_unified_phase.py           # stage-2 serving
    python3 tools/torch_unified_phase.py --train   # stage-2 training

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
    train = "--train" in sys.argv[1:]
    phase = chip_smoke.unified_train_phase if train \
        else chip_smoke.unified_phase
    t0 = time.time()
    phase(card, torch.device("cuda"), None)
    print(f"{'unified_train' if train else 'unified'} phase alone: "
          f"{time.time() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
