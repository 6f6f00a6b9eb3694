"""Training driver with checkpoint/restart fault tolerance (port of
``repro/launch/train.py``).

Trains any config of the registry (``models/api.get_model``: the
decoder-only transformers, xLSTM, the Hymba hybrid, the encoder-decoder,
whose batches carry random frames) on the deterministic synthetic stream
(``data/pipeline.py``) with AdamW (``optim/adamw.py``; ``--moment-dtype
bdi8`` keeps the moments as BDI tiles, compressed and decompressed by the
tile kernels on the card).  Fault-tolerance contract, as in the JAX
package:

  * checkpoint every ``--ckpt-every`` steps and at the last step (atomic,
    verified, compressed — ``checkpoint/store.py``, the JAX on-disk
    format, the optimizer state in the JAX package's layout) with params,
    optimizer state and the data cursor; the three newest are kept;
  * on start, resume from the latest checkpoint (the stream replays from
    the saved step, so a relaunch continues the run);
  * ``--deadline-s`` bounds wall time and forces a checkpoint before exit.

Runs on the card unless asked for the CPU (``--device cpu``, the plain
versions); raises without CUDA.  Full width is the default, ``--smoke``
shrinks the model to its reduced config.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b \\
      [--smoke --device cpu] [--steps 50 --ckpt-dir DIR] \\
      [--moment-dtype f32|bf16|bdi8|q8]
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import store
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_arch
from repro_torch.data.pipeline import DataConfig, DataIterator
from repro_torch.distributed import axes as AX
from repro_torch.distributed import sharding as SH
from repro_torch.distributed import tp
from repro_torch.kernels._device import resolve_device
from repro_torch.models import params as P
from repro_torch.models.api import ModelAPI, get_model
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.adamw import MOMENT_DTYPES, export_state, import_state


def make_train_step(model: ModelAPI, ocfg: AdamWConfig):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``:
    the loss, its gradients over the parameter leaves, then the AdamW
    update (in place, see ``optim/adamw.py``).  ``metrics`` holds Python
    floats: ``loss``, ``grad_norm``, and the host seconds of the forward
    and backward (``fwd_bwd_s``) and of the update (``opt_s``), each
    ending in a read of its result, which waits for the device, and
    ``collectives``: by mesh axis (``model``, ``data``), the collectives
    the step issued and the bytes of their inputs (``distributed/
    tp.COUNTS``; zeros without a mesh).

    Under a ``(d, m)`` mesh (``distributed/axes.use_mesh``) ``params``
    and ``opt_state`` are this rank's blocks (``distributed/sharding.
    local_params``, ``fsdp=True`` for JAX's training layout; ``adamw_init``
    of them, with ``whole=`` the model's shapes under a data axis) and
    every rank takes the whole batch, which the step cuts to its rows
    (``sharding.local_batch``; rows that do not divide d stay whole): the
    loss is the global mean on every rank, the gradients are this rank's
    blocks and ``grad_norm`` is the global norm."""
    meta = {}

    def step(params, opt_state, batch):
        c0 = tp.counts()
        t0 = time.perf_counter()
        whole, d, rows = None, tp.data_size(), 0
        if d > 1 or tp.model_size() > 1:
            if "params" not in meta:
                meta["params"] = model.init(torch.Generator(), "meta")
            whole = meta["params"]
        if d > 1:
            rows = next(iter(batch.values())).shape[0]
            batch = SH.local_batch(batch, AX.current_mesh())
        with tp.whole_rows(d > 1 and rows % d != 0):
            leaves = [t.requires_grad_() for t in P.leaves(params)]
            loss = model.loss(params, batch)
            # a leaf the loss does not reach (xLSTM's idle cell in a block)
            # gets a zero gradient, as jax.grad gives it
            grads = P.unflatten(params, torch.autograd.grad(
                loss, leaves, allow_unused=True, materialize_grads=True))
        loss = float(loss.detach())
        t1 = time.perf_counter()
        params, opt_state, m = adamw_update(params, grads, opt_state, ocfg,
                                            whole=whole)
        del grads
        gnorm = float(m["grad_norm"])
        return params, opt_state, {
            "loss": loss, "grad_norm": gnorm, "fwd_bwd_s": t1 - t0,
            "opt_s": time.perf_counter() - t1,
            "collectives": tp.counts_since(c0)}
    return step


def train(arch: str, *, smoke: bool = True, steps: int = 100,
          seq_len: int = 128, batch: int = 8, lr: float = 3e-4,
          ckpt_dir: str | None = None, ckpt_every: int = 25,
          deadline_s: float = 0.0, moment_dtype: str = "f32",
          log_every: int = 10,
          device: str | torch.device | None = None) -> dict:
    """Train ``arch`` for ``steps`` steps (resuming from ``ckpt_dir``'s
    latest checkpoint).  Returns the JAX driver's dict (``first_loss``,
    ``final_loss``, ``steps_run``, ``losses``, ``params``) plus
    ``opt_state`` and ``step_s``, each step's ``(fwd_bwd_s, opt_s)``.
    Runs no mesh: under a model or data axis it raises (the train step
    runs there, :func:`make_train_step`)."""
    tp.refuse_model_axis("launch/train.train()")
    dev = resolve_device(device)
    cfg = get_arch(arch)
    if smoke:
        cfg = cfg.reduced()
    shape = ShapeConfig("train", seq_len, batch, "train")
    model = get_model(cfg)
    ocfg = AdamWConfig(lr=lr, moment_dtype=moment_dtype)

    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    opt_state = adamw_init(params, ocfg)
    start_step = 0
    data_seed = 0

    if ckpt_dir and store.latest_step(ckpt_dir) is not None:
        (params, opt_state), manifest = store.restore(
            ckpt_dir, (params, opt_state))
        opt_state = import_state(opt_state)
        start_step = manifest["extra"]["next_step"]
        data_seed = manifest["extra"]["data_seed"]
        print(f"[train] resumed from step {start_step}")

    it = DataIterator(cfg, shape, DataConfig(seed=data_seed),
                      start_step=start_step)
    step_fn = make_train_step(model, ocfg)

    t0 = time.time()
    losses, step_s = [], []
    i = start_step
    for i in range(start_step, steps):
        batch_i = {k: torch.from_numpy(v).to(dev)
                   for k, v in next(it).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch_i)
        losses.append(metrics["loss"])
        step_s.append((metrics["fwd_bwd_s"], metrics["opt_s"]))
        if i % log_every == 0:
            print(f"[train] step {i} loss {losses[-1]:.4f} "
                  f"gnorm {metrics['grad_norm']:.3f}")
        hit_deadline = deadline_s and (time.time() - t0) > deadline_s
        if ckpt_dir and ((i + 1) % ckpt_every == 0 or i == steps - 1
                         or hit_deadline):
            store.save(ckpt_dir, i + 1, (params, export_state(opt_state)),
                       extra={"next_step": i + 1, "data_seed": data_seed,
                              "loss": losses[-1]})
            store.prune_old(ckpt_dir, keep=3)
        if hit_deadline:
            print(f"[train] deadline hit at step {i}; checkpointed + exit")
            break
    return {"final_loss": losses[-1] if losses else None,
            "first_loss": losses[0] if losses else None,
            "steps_run": i + 1 - start_step, "losses": losses,
            "params": params, "opt_state": opt_state, "step_s": step_s}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="shrink the model to its reduced smoke config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--deadline-s", type=float, default=0.0)
    ap.add_argument("--moment-dtype", default="f32", choices=MOMENT_DTYPES)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain PyTorch versions)")
    args = ap.parse_args()
    out = train(args.arch, smoke=args.smoke, steps=args.steps,
                seq_len=args.seq_len, batch=args.batch, lr=args.lr,
                ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                deadline_s=args.deadline_s, moment_dtype=args.moment_dtype,
                device=args.device)
    print(f"[train] done: first={out['first_loss']:.4f} "
          f"final={out['final_loss']:.4f}")


if __name__ == "__main__":
    main()
