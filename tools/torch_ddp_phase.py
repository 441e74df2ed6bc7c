#!/usr/bin/env python3
"""Phases ``ddp`` (13), ``export`` (19) and ``mesh`` (20) of chip_smoke.py
alone, in a fresh process, on one card, as the script runs them.

    python3 tools/torch_ddp_phase.py                 # phases 13, 19, 20
    python3 tools/torch_ddp_phase.py --replicated 3  # phase 13's
                                                     # ReplicatedServer
                                                     # part, 3 times

Builds kernel B1, then runs phase ddp's two launches (2 gloo ranks: stage
1 from the user YAML file, stage 1 under FSDP, stage 2, stage 2 under
tensor parallelism; 1 nccl rank: stages 1 and 2) while this process makes
phase export's exports beside them, phase ddp's gates and its
ReplicatedServer, phase export's card part and phase mesh (the gates of
the launch's mesh runs and the mesh server), with the script's inputs,
gates and prints.  ``--replicated N`` repeats only the replicated-serving
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
        print(f"replicated alone: {time.time() - t0:.1f} s", flush=True)
        return
    import warnings
    # as chip_smoke.py: the slice's scenes outgrow the YAML's deep level
    # caps, which pad those levels to buckets
    warnings.filterwarnings("ignore", message="level .* > configured cap")
    dev = torch.device("cuda")
    prep = {}
    dd = chip_smoke.ddp_phase(
        card, zrun_conv,
        beside=lambda: prep.update(chip_smoke.export_prepare(card, dev)))
    print(f"timing: phase 13 {time.time() - t0:.1f} s", flush=True)
    t1 = time.time()
    chip_smoke.export_phase(card, dev, zrun_conv, prep)
    del prep
    torch.cuda.empty_cache()
    print(f"timing: phase 19 {time.time() - t1:.1f} s", flush=True)
    t1 = time.time()
    chip_smoke.mesh_phase(card, zrun_conv, dd)
    print(f"timing: phase 20 {time.time() - t1:.1f} s", flush=True)
    print(f"phases 13, 19 and 20 alone: {time.time() - t0:.1f} s",
          flush=True)


if __name__ == "__main__":
    main()
