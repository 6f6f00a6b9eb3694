"""Fault-tolerance walkthrough: BDI-compressed checkpoints and crash
recovery (port of ``examples/compressed_checkpointing.py``).

Trains the reduced yi-6b for 30 steps with a checkpoint every 10,
"crashes", relaunches and resumes at step 30 to continue to 60 from the
trained state, then reports the newest manifest's compression ratio
(lossless BDI streams behind the EC gate).  Runs on the card unless
asked for the CPU; raises without CUDA.

Run: PYTHONPATH=src python -m repro_torch.launch.compressed_checkpointing
     [--ckpt-dir DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch

from repro_torch.launch.train import train


def main(ckpt_dir: str | None = None,
         device: str | torch.device | None = None) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = ckpt_dir or os.path.join(tmp, "ckpt")
        print("== phase 1: train 30 steps, checkpoint every 10 ==")
        out1 = train("yi-6b", smoke=True, steps=30, ckpt_dir=ckpt,
                     ckpt_every=10, log_every=10, device=device)
        print("== phase 2: 'crash' + relaunch -> resumes from step 30 ==")
        out2 = train("yi-6b", smoke=True, steps=60, ckpt_dir=ckpt,
                     ckpt_every=10, log_every=10, device=device)
        if out2["steps_run"] != 30:
            raise AssertionError(f"should resume, not restart: ran "
                                 f"{out2['steps_run']} steps")
        if not out2["losses"][0] < out1["losses"][0]:
            raise AssertionError("resumed run must continue from the "
                                 "trained state")
        print(f"resume OK: loss continued {out1['final_loss']:.3f} -> "
              f"{out2['final_loss']:.3f}")
        with open(os.path.join(ckpt, sorted(os.listdir(ckpt))[-1],
                               "manifest.json")) as f:
            man = json.load(f)
    print(f"checkpoint compression (BDI streams + EC gate): "
          f"{man['compression_ratio']:.2f}x over "
          f"{len(man['entries'])} tensors")
    return {"first": out1, "resumed": out2,
            "compression_ratio": man["compression_ratio"],
            "tensors": len(man["entries"])}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a fresh temporary "
                         "one, removed at the end)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain PyTorch versions)")
    args = ap.parse_args()
    main(args.ckpt_dir, args.device)
