"""Median ms of the PyTorch port's eager training step on the card.

``Trainer.train_step`` on the canonical Cond_SRVAE (cr=1.2, patch 64, B=512:
LR 32x32x4 and HR 64x64x4, uniform x1000 from numpy seed 0), in float32 and
in bfloat16, TF32 off: a warm window, then ``--windows`` windows of 4 steps,
one sync a window.

    python3 scripts/torch_step_time.py [--root DIR] [--windows 5] [--tag NAME]

``--root`` imports the port from another checkout (a parent commit unpacked
with ``git archive``), so that two versions are timed on one card in one
run of the machine, alternating them: parent, change, change, parent.
Prints one JSON line: the tag, the card's name and power limit
(``nvidia-smi``), and per dtype the median and every window's ms a step.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

STEPS = 4  # steps a window


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    help="the checkout whose simple_vae_rs_tpu_torch is timed")
    ap.add_argument("--windows", type=int, default=5)
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_step_time: no CUDA card", file=sys.stderr)
        return 1
    from simple_vae_rs_tpu_torch import CondSRVAE, CondSRVAEConfig, TrainConfig, Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    rng = np.random.default_rng(0)
    batch = tuple(torch.from_numpy(rng.random(s, dtype=np.float32) * 1000).cuda()
                  for s in ((512, 32, 32, 4), (512, 64, 64, 4)))
    out = {"tag": args.tag, "root": os.path.abspath(args.root), "card": card}
    for dtype, label in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        model = CondSRVAE(CondSRVAEConfig(cr=1.2, patch_size=64), device="cuda", dtype=dtype)
        tr = Trainer(model.init_weights(0),
                     TrainConfig(learning_rate=1e-4, use_bfloat16=dtype == torch.bfloat16),
                     device="cuda", seed=7)

        def window():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(STEPS):
                tr.train_step(batch)
            torch.cuda.synchronize()
            return 1e3 * (time.perf_counter() - t0) / STEPS

        window()
        ms = [window() for _ in range(args.windows)]
        out[label] = {"median_ms": statistics.median(ms), "ms": ms}
        del tr, model
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
