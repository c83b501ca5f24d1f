"""End-to-end LM training driver on the PyTorch port (~115M-parameter
config; ``--small`` for the smoke config).

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 300] [--small] \
        [--device cpu]

Trains a reduced qwen3-family model on the structured synthetic corpus
with the full production substrate: deterministic restartable pipeline,
AdamW (+cosine schedule, grad clip), checkpointing, health tracking.
Runs on the card unless ``--device cpu`` is given.
"""
import argparse
import os
import tempfile

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import TokenPipeline
from repro_torch.models.config import ModelConfig
from repro_torch.models.steps import (init_train_state, make_train_step,
                                      param_tree)
from repro_torch.optim import AdamWConfig, adamw
from repro_torch.runtime import StepTimer


def lm_100m() -> ModelConfig:
    # ~115M params: qwen3-family block (qk_norm, GQA, swiglu, tied embed)
    return ModelConfig(
        name="repro-115m", family="dense", n_layers=12, d_model=768,
        n_heads=12, n_kv_heads=4, d_ff=2048, vocab=32768, qk_norm=True,
        tie_embeddings=True, dtype="float32", loss_chunk=128,
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a new temporary "
                         "one)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    if args.small:
        from repro_torch.configs import get_smoke_config

        cfg = get_smoke_config("qwen3-0.6b")
        args.steps = min(args.steps, 60)
    else:
        cfg = lm_100m()
    print(f"config {cfg.name}: {cfg.n_params() / 1e6:.1f}M params")
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps,
                       moment_dtype="float32")
    gen = torch.Generator(args.device).manual_seed(0)
    model, opt_state = init_train_state(cfg, ocfg, gen, args.device)
    pipe = TokenPipeline(cfg, device=args.device)
    step = make_train_step(cfg, ocfg)
    ckpt_dir = args.ckpt_dir or os.path.join(
        tempfile.mkdtemp(prefix="repro_train_lm_"), "ckpt")
    manager = CheckpointManager(ckpt_dir, interval=max(args.steps // 3, 1))
    timer = StepTimer()
    first = None
    for i in range(args.steps):
        batch = pipe.batch(i, args.batch, args.seq)
        timer.start()
        model, opt_state, m = step(model, opt_state, batch)
        loss = float(m["loss"])
        timer.stop()
        first = first if first is not None else loss
        params = adamw.tree_map(adamw.value, param_tree(model))
        manager.maybe_save(i, (params, opt_state),
                           extra={"pipeline_index": i})
        if i % 20 == 0 or i == args.steps - 1:
            tok_s = args.batch * args.seq / max(timer.ewma, 1e-9)
            print(f"step {i:5d}  loss {loss:.4f}  grad_norm "
                  f"{float(m['grad_norm']):.2f}  {tok_s:,.0f} tok/s")
    print(f"\nloss {first:.3f} -> {loss:.3f} over {args.steps} steps")
    assert loss < first - 0.3, "loss did not decrease"
    print("OK")


if __name__ == "__main__":
    main()
