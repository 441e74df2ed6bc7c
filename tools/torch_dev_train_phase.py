#!/usr/bin/env python3
"""Phase ``dev_train`` (9c) of chip_smoke.py alone, in a fresh process, on
one card, with the two other stage checks the port's last slice added.

    python3 tools/torch_dev_train_phase.py

Runs, as chip_smoke.py does (same inputs, gates and prints): phase 9c
(stage-1 training with the maps built on the card: dev_maps and
dev_flat_zt timed and gated against the host's maps, dev_gather and
dev_flat_swin one step each) without phase 8 beside it, then phase 14's
``vertical_bottom`` forward.  Then the stage-2 model of
unified_tasks_sceneverse with ``early_exit`` on one batch of 8 requests:
the first eager call in this process (the decode's ``torch.while_loop``
captured by torch's compiler), a second one, and the fixed-length decode,
each timed on the host clock around a synchronise, with the tokens of
all three gated equal.  Ends with one JSON line of the readings.
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402


def early_exit_calls(card, dev):
    """Eager early-exit forwards (first, second) against the fixed-length
    one: seconds each and tokens gated equal."""
    import torch
    from pq3d_tpu_torch.config import load_config
    from pq3d_tpu_torch.data.unified_pipeline import UnifiedPipelineConfig
    from pq3d_tpu_torch.models.query3d import build_model
    from pq3d_tpu_torch.serve import to_device
    cfg = load_config("unified_tasks_sceneverse")
    pipe = UnifiedPipelineConfig(**cfg["data"]["unified_options"])
    b = to_device(chip_smoke.variant_batch(
        chip_smoke.unified_requests(8, seed=3), pipe,
        {"mv": 768, "voxel": 128}, 6), dev)
    model = build_model(cfg, device="cuda", seed=0).eval()
    fixed_cfg = model.generation_head.cfg
    out = {}
    for label, early in (("early_exit_first", True),
                         ("early_exit_second", True), ("fixed", False)):
        model.generation_head.cfg = dataclasses.replace(fixed_cfg,
                                                        early_exit=early)
        torch.cuda.synchronize()
        t0 = time.time()
        with torch.inference_mode():
            toks = model(b)["generation_tokens"]
        torch.cuda.synchronize()
        out[label] = (time.time() - t0, toks)
    same = all(torch.equal(t, out["fixed"][1]) for _, t in out.values())
    secs = {k: v[0] for k, v in out.items()}
    print(f"early_exit: one stage-2 forward of 8 requests (50-token "
          f"decode): eager early exit {secs['early_exit_first']:.2f} s at "
          f"its first call in this process (the loop's capture included), "
          f"{secs['early_exit_second']:.3f} s at its second, fixed length "
          f"{secs['fixed']:.3f} s; tokens {'equal' if same else 'DIFFER'} "
          f"({card})", flush=True)
    if not same:
        chip_smoke.fail("early_exit: the eager early-exit tokens differ "
                        "from the fixed-length decode's")
    return secs


def main():
    import torch
    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is false")
    from pq3d_tpu_torch.config import load_config
    from pq3d_tpu_torch.data.unified_pipeline import UnifiedPipelineConfig
    from pq3d_tpu_torch.ops import hungarian, zrun_conv
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    t0 = time.time()
    zrun_conv.build()
    hungarian.build()
    print(f"build: {time.time() - t0:.1f} s", flush=True)
    exp = tempfile.mkdtemp(prefix="pq3d_dev_train_")
    t0 = time.time()
    try:
        dt = chip_smoke.dev_train_phase(card, zrun_conv, exp, None)
    finally:
        shutil.rmtree(exp, ignore_errors=True)
    dt_s = time.time() - t0
    torch.cuda.empty_cache()
    cfg = load_config("unified_tasks_sceneverse")
    pipe = UnifiedPipelineConfig(**cfg["data"]["unified_options"])
    nb = chip_smoke.variant_batch(chip_smoke.unified_requests(8, seed=3),
                                  pipe, {"mv": 768, "voxel": 128}, 6,
                                  response=True)
    vb = chip_smoke.vertical_bottom_forward(nb, dev, card)
    ee = early_exit_calls(card, dev)
    print(json.dumps({
        "card": card, "dev_train_s": dt_s,
        "dev_train": {k: {kk: v for kk, v in r.items()
                          if kk not in ("steps", "host_s")}
                      for k, r in dt.items()},
        "vertical_bottom": vb, "early_exit_s": ee}, default=str),
        flush=True)


if __name__ == "__main__":
    main()
