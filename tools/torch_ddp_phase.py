#!/usr/bin/env python3
"""Phase ``ddp`` of chip_smoke.py alone, in a fresh process, on one card.

    python3 tools/torch_ddp_phase.py                 # the whole phase
    python3 tools/torch_ddp_phase.py --replicated 3  # its ReplicatedServer
                                                     # part, 3 times

Builds kernel B1, then runs the phase as chip_smoke.py does (same inputs,
gates and prints).  ``--replicated N`` repeats only the replicated-serving
part N times, which shows how far the single server and the replicas part
from run to run with the decoder's self-mask on (printed, not gated) beside
the gated self-mask-off difference.
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
    import torch
    from pq3d_tpu_torch.ops import zrun_conv
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--replicated", type=int, default=0, metavar="N",
                    help="run only the ReplicatedServer part, N times")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is false")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    zrun_conv.build()
    t0 = time.time()
    if args.replicated:
        for _ in range(args.replicated):
            chip_smoke.replicated_phase(card, zrun_conv)
    else:
        chip_smoke.ddp_phase(card, zrun_conv)
    print(f"ddp phase alone: {time.time() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
