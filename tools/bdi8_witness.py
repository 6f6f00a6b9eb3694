"""bdi8's lost second moments in both packages, on the CPU.

Trains one configuration with the port's ``train()`` and with the JAX
package's, from one step-0 checkpoint (the port's init, zero moments),
under ``bdi8`` and ``f32`` moments, and reports for each run the losses,
each param leaf's largest magnitude, and, under ``bdi8``, the share of
elements whose stored v loads as 0 while their stored m does not (such
an element moves by lr * m / eps when its next gradient is 0).

The configuration is yi-6b's head width with 2 layers, d_model 1024, 8
heads, 2 KV heads, d_ff 2816 and a vocabulary of 16000, at seq 128 x
batch 8: small enough for a CPU, wide enough that bdi8 loses v in the
MLP and output leaves as it does at full width.  The vocabulary keeps
the embedding and head under the 2^24 elements above which the JAX
update scans a leaf row by row, which on the CPU takes minutes a step.
The JAX side runs in a subprocess with
``XLA_FLAGS=--xla_allow_excess_precision=false`` and its
``bdi_value._pow2_scale`` swapped for the exact 2^e-from-bits
construction, as the parity tests run it, so a single update is
bit-equal to the port's.

Usage (from the repository root):
  PYTHONPATH=src python tools/bdi8_witness.py [--steps 24] \\
      [--out results/bdi8_witness.json]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

SHAPE = dict(n_layers=2, d_model=1024, n_heads=8, n_kv_heads=2,
             d_ff=2816, vocab=16000)
NAME = "yi-6b-2l-d1024"
TRAIN = dict(smoke=False, seq_len=128, batch=8, ckpt_every=10_000,
             log_every=10_000)
DTYPES = ("bdi8", "f32")


def exact_pow2_scale(maxres, qmax):
    """``bdi_value._pow2_scale`` with 2^e built from its bits."""
    import jax
    import jax.numpy as jnp
    ratio = (maxres / qmax).astype(jnp.float32)
    bits = jax.lax.bitcast_convert_type(ratio, jnp.int32)
    e = ((bits >> 23) & 0xFF) - 127 + ((bits & 0x7FFFFF) != 0)
    s = jax.lax.bitcast_convert_type(
        jnp.where(e >= -126, (e + 127) << 23, 1 << 22).astype(jnp.int32),
        jnp.float32)
    return jnp.where(maxres > 0, s, jnp.float32(1.0))


def jax_side(work: str, steps: int) -> None:
    """Subprocess entry: JAX's train() from each step-0 checkpoint."""
    from repro.configs import registry
    from repro.core import bdi_value as jbv
    jbv._pow2_scale = exact_pow2_scale            # before the first trace
    from repro.launch.train import train
    registry.ARCHS[NAME] = registry.get_arch("yi-6b").reduced(
        **SHAPE, name=NAME)
    out = {}
    for md in DTYPES:
        out[md] = train(NAME, steps=steps, ckpt_dir=f"{work}/jax_{md}",
                        moment_dtype=md, **TRAIN)["losses"]
    with open(f"{work}/jax.json", "w") as f:
        json.dump(out, f)


def stats(ckpt: str, cfg, md: str) -> dict:
    """Largest |param| of each leaf and, under bdi8, the lost-v shares
    of the checkpoint's last step (read by the port's store)."""
    import torch
    from repro_torch.checkpoint import store
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import AdamWConfig, adamw, adamw_init
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    state = adamw.export_state(adamw_init(params, AdamWConfig(
        moment_dtype=md)))
    (params, state), _ = store.restore(ckpt, (params, state))
    state = adamw.import_state(state)
    res = {"max_abs_param": {}, "lost_v": {}}
    lost = total = 0
    for (name, p), m_s, v_s in zip(store.leaf_paths(params),
                                   adamw._store_leaves(state["m"]),
                                   adamw._store_leaves(state["v"])):
        res["max_abs_param"][name] = float(p.float().abs().max())
        m, v = adamw._load(m_s, p.shape), adamw._load(v_s, p.shape)
        n = int(((v == 0) & (m != 0)).sum())
        res["lost_v"][name] = n / p.numel()
        lost, total = lost + n, total + p.numel()
    res["lost_v_all"] = lost / total
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--out", default="results/bdi8_witness.json")
    args = ap.parse_args()

    import torch
    from repro_torch.checkpoint import store
    from repro_torch.configs import registry
    from repro_torch.launch.train import train
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import AdamWConfig, adamw, adamw_init
    cfg = registry.get_arch("yi-6b").reduced(**SHAPE, name=NAME)
    registry.ARCHS[NAME] = cfg
    report = {"config": SHAPE, "steps": args.steps, "seq_len": 128,
              "batch": 8}
    with tempfile.TemporaryDirectory() as work:
        params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        for md in DTYPES:
            init = f"{work}/init_{md}"
            store.save(init, 0, (params, adamw.export_state(adamw_init(
                params, AdamWConfig(moment_dtype=md)))),
                extra={"next_step": 0, "data_seed": 0, "loss": None})
            for side in ("port", "jax"):
                shutil.copytree(init, f"{work}/{side}_{md}")
        for md in DTYPES:
            report[f"port_{md}"] = {"losses": train(
                NAME, steps=args.steps, ckpt_dir=f"{work}/port_{md}",
                moment_dtype=md, device="cpu", **TRAIN)["losses"]}
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") +
                              " --xla_allow_excess_precision=false").strip())
        here = os.path.dirname(os.path.abspath(__file__))
        subprocess.run([sys.executable, "-c",
                        f"import sys; sys.path.insert(0, {here!r}); "
                        "import bdi8_witness as w; "
                        f"w.jax_side({work!r}, {args.steps})"],
                       env=env, check=True)
        with open(f"{work}/jax.json") as f:
            jax_losses = json.load(f)
        for md in DTYPES:
            report[f"jax_{md}"] = {"losses": jax_losses[md]}
            for side in ("port", "jax"):
                report[f"{side}_{md}"].update(
                    stats(f"{work}/{side}_{md}", cfg, md))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    for key in ("port_bdi8", "jax_bdi8", "port_f32", "jax_f32"):
        r = report[key]
        print(key, "losses", " ".join(f"{x:.3f}" for x in r["losses"]))
        print("   lost v", f"{r['lost_v_all']:.4f}", "max|p|",
              {k: round(v, 3) for k, v in r["max_abs_param"].items()})
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
