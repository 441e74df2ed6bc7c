#!/usr/bin/env python3
"""The spread of phase 15's bf16 gate over repeated forwards, on one card.

    python3 tools/torch_bf16_spread.py [--reps 8]

For the full-width swin model (flat_swin) and the stage-1 Res16UNet
(flat_zt), random weights from seed 0, reads chip_smoke.bf16_reading on
phase 15's checked batch (its first 4 timed scenes) ``--reps`` times: the
f32 forward against the bf16 cast's, every decoder round up to the first
flipped attend bit, with each round's class and mask errors, the number
of scenes still compared and the mask logits' scale.  The forwards are
the same each time; what moves is the order in which the card's atomic
adds sum the cast's bf16 segment means.
"""
import argparse
import copy
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=8)
    args = ap.parse_args()
    import numpy as np
    import torch
    from pq3d_tpu_torch.config import serving_config
    from pq3d_tpu_torch.data.instseg_pipeline import (make_batch,
                                                      pipeline_config)
    from pq3d_tpu_torch.models.query3d import build_model
    from pq3d_tpu_torch.serve import to_device
    from pq3d_tpu_torch.utils.inference import (cast_batch_bf16,
                                                cast_model_bf16)
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    over = [f"data.instseg_options.level_caps={cs.LAYOUT_CAPS}"]
    scenes = cs.make_scenes(4, seed=3)
    for lay in ("flat_swin", "flat_zt"):
        cfg = serving_config(lay, over)
        pipe = pipeline_config(cfg["data"]["instseg_options"])
        b = to_device({k: v for k, v in make_batch(
            [dict(s) for s in scenes], pipe,
            np.random.default_rng(0)).items() if k != "_meta"}, dev)
        for name, dim in cs.SERVE_EXTRA.items():
            b[f"{name}_seg_fts"] = torch.zeros(4, pipe.max_segments, dim,
                                               device=dev)
            b[f"{name}_seg_pad_masks"] = b["seg_pad_masks"]
        model = build_model(cfg, device="cuda", seed=0)
        bf_model = cast_model_bf16(copy.deepcopy(model))
        valid = b["seg_pad_masks"]
        for rep in range(args.reps):
            with torch.inference_mode():
                ref = cs.out_rounds(model(b))
                got = cs.out_rounds(bf_model(cast_batch_bf16(b)))
            r = cs.bf16_reading(ref, got, valid)
            per = []
            for i, (pair, pair_got, v) in enumerate(
                    cs.per_round(ref, got, valid)):
                e, em, _, _ = cs.instseg_bf16_gate(pair, pair_got, v)
                scale = pair[1][v[:, :, None].expand_as(pair[1])].abs().max()
                per.append((i, round(e, 4), round(em, 4), len(v),
                            round(scale.item(), 3)))
            print(f"{lay} forward {rep}: {cs.bf16_text(r)} | by round "
                  f"(round, class rel, mask rel, scenes, mask scale) {per} "
                  f"({card})", flush=True)
        del model, bf_model
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
