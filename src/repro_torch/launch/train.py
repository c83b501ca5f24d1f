"""Training launcher: the data pipeline into a ``make_train_step`` loop with
checkpointing and step-time tracking (the port of
``repro.launch.train``).

    python -m repro_torch.launch.train --arch qwen3-0.6b \
        [--steps 50 --batch 8 --seq 128 --full --ckpt-dir DIR --device cuda]

The reference's seeds, schedule (10 warmup steps, a cosine over
``steps``), checkpoint interval (``max(steps // 3, 1)``), resume (at the
step after the newest committed one) and log line. A checkpoint holds
``(params, opt_state)`` in the reference's layout (each segment's layers
stacked, the same keys), so a step written by either package restores in
the other. It runs on the card unless ``--device cpu`` is given, and never
falls back to the CPU.

The reference's ``mesh=`` (its parameters sharded over a device mesh) and
``tpu_xla_flags()`` (XLA's collective-overlap flags) have no counterpart:
the port trains on one device, and torch has no XLA flags.
"""
from __future__ import annotations

import argparse
import logging

import torch

from ..checkpoint import CheckpointManager, restore
from ..configs import get_config, get_smoke_config
from ..data import TokenPipeline
from ..device import resolve_device
from ..models import steps as steps_mod
from ..optim import adamw
from ..runtime import StepTimer

log = logging.getLogger("repro_torch.train")


def _checkpoint_tree(model, opt_state):
    """``(params, opt_state)``: the parameters stacked into the
    reference's tree."""
    return (adamw.tree_map(adamw.value, steps_mod.param_tree(model)),
            opt_state)


def train(arch: str, *, steps: int = 50, batch: int = 8, seq: int = 128,
          smoke: bool = True, ckpt_dir: str | None = None,
          log_every: int = 10, opt_overrides: dict | None = None,
          device=None):
    """Train ``arch`` (its SMOKE config unless ``smoke=False``) for
    ``steps`` steps of ``batch`` × ``seq`` tokens from ``TokenPipeline``;
    with ``ckpt_dir``, resume from its newest committed step and save
    every ``max(steps // 3, 1)`` steps. Returns ``(model, opt_state,
    losses)``, the losses of the steps this call ran."""
    dev = resolve_device(device)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    ocfg = adamw.AdamWConfig(moment_dtype=cfg.optimizer_dtype,
                             warmup_steps=10, total_steps=steps,
                             **(opt_overrides or {}))
    pipe = TokenPipeline(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    model, opt_state = steps_mod.init_train_state(cfg, ocfg, gen, dev)
    step_fn = steps_mod.make_train_step(cfg, ocfg)
    manager = (CheckpointManager(ckpt_dir, interval=max(steps // 3, 1))
               if ckpt_dir else None)
    start = 0
    if manager is not None:
        try:
            (params, opt_state), start, _ = restore(
                manager.directory, _checkpoint_tree(model, opt_state),
                device=dev)
        except FileNotFoundError:
            pass
        else:
            with torch.no_grad():
                for (_, leaf), (_, saved) in zip(
                        adamw.tree_paths(steps_mod.param_tree(model)),
                        adamw.tree_paths(params)):
                    if (tuple(saved.shape), saved.dtype) != (
                            tuple(leaf.shape), leaf.dtype):
                        raise ValueError(
                            f"checkpoint leaf {saved.dtype}"
                            f"{list(saved.shape)} for a parameter "
                            f"{leaf.dtype}{list(leaf.shape)}")
                    adamw.assign(leaf, saved)
            start += 1
            log.info("resumed at step %d", start)
    timer = StepTimer()
    losses = []
    for i in range(start, steps):
        b = pipe.batch(i, batch, seq)
        timer.start()
        model, opt_state, metrics = step_fn(model, opt_state, b)
        loss = float(metrics["loss"])
        timer.stop()
        losses.append(loss)
        if manager is not None:
            manager.maybe_save(i, _checkpoint_tree(model, opt_state),
                               extra={"pipeline_index": i})
        if i % log_every == 0 or i == steps - 1:
            print(f"[train {arch}] step {i:5d} loss {loss:.4f} "
                  f"({timer.ewma:.3f}s/step ewma)")
    return model, opt_state, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true",
                    help="full (non-smoke) config")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    train(args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
          smoke=not args.full, ckpt_dir=args.ckpt_dir, device=args.device)


if __name__ == "__main__":
    main()
