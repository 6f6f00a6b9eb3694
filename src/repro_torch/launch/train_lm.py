"""End-to-end training driver: a ~100M-parameter LM for a few hundred
steps with checkpoint/restart and BDI-compressed optimizer moments (port
of ``examples/train_lm.py``).

yi-100m: the yi family at 8 layers x d_model 768 x 12 heads (4 KV) x
d_ff 2048 x vocab 50304, sequences of 256, batch 8, ``bdi8`` moments
(the tile kernels on the card), a checkpoint every 50 steps.  Fails
unless the loss drops by more than 0.5.  Runs on the card unless asked
for the CPU; raises without CUDA.

Run: PYTHONPATH=src python -m repro_torch.launch.train_lm [--steps 200]
     [--ckpt-dir DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import tempfile

import torch

from repro_torch.configs import registry
from repro_torch.launch.train import train


def yi_100m():
    """The ~100M-parameter member of the yi family, registered by name."""
    cfg = dataclasses.replace(
        registry.get_arch("yi-6b"), name="yi-100m", n_layers=8,
        d_model=768, head_dim=0, n_heads=12, n_kv_heads=4, d_ff=2048,
        vocab=50_304)
    registry.ARCHS[cfg.name] = cfg
    return cfg


def main(steps: int = 200, ckpt_dir: str | None = None,
         device: str | torch.device | None = None) -> dict:
    cfg = yi_100m()
    with tempfile.TemporaryDirectory() as tmp:
        out = train(cfg.name, smoke=False, steps=steps, seq_len=256,
                    batch=8, lr=3e-4, ckpt_dir=ckpt_dir or tmp,
                    ckpt_every=50, moment_dtype="bdi8", log_every=20,
                    device=device)
    drop = out["first_loss"] - out["final_loss"]
    print(f"loss {out['first_loss']:.3f} -> {out['final_loss']:.3f} "
          f"(drop {drop:.3f}) over {out['steps_run']} steps "
          f"[bdi8-compressed moments]")
    if drop <= 0.5:
        raise AssertionError(f"training did not learn: drop {drop:.3f}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a fresh temporary "
                         "one, removed at the end)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain PyTorch versions)")
    args = ap.parse_args()
    main(args.steps, args.ckpt_dir, args.device)
