"""End-to-end driver: train a ~100M-parameter LM with the full substrate
(data pipeline w/ Clock2Q+ index cache, AdamW, remat, checkpoint/resume).

The port of ``examples/train_100m.py`` on ``repro_torch``, on the card
unless ``--device cpu`` is given: attention's forward on the
``flash_attention`` kernel and its gradient on ``flash_attention_bwd``
(fp32, their CUDA-core route).  On an NVIDIA H100 80GB HBM3 at a
700 W power limit (``nvidia-smi --query-gpu=name,power.limit``),
``chip_smoke.py``'s ``examples_main`` measured a step of the default run
(seq 128, batch 4: 512 tokens) at 61.2 to 130.5 ms, the median of steps
2-8 in three runs on hosts of different speed: 3,900 to 8,400 tokens/s.
Pass --steps 300 for the real "few hundred steps" run; a rerun with
the same --ckpt resumes from its latest step.

    PYTHONPATH=src python examples/torch/train_100m.py --steps 8 \\
        [--device cpu]
"""

import argparse
import os
import tempfile
import time

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import build
from repro_torch.training import optim, step as step_lib

# ~124M parameters (GPT-2-small-class, SwiGLU/RMSNorm/RoPE)
CFG_100M = ModelConfig(
    name="lm-100m", family="dense", n_layers=12, d_model=768,
    n_heads=12, n_kv_heads=12, d_ff=2048, vocab=32_000,
    norm="rmsnorm", act="swiglu", dtype="float32", param_dtype="float32")


def main(argv=None, state=None) -> dict:
    """Train (resuming from the latest checkpoint under --ckpt); return
    {"start", "losses", "step_s" (each step's seconds, its loss read
    back), "tokens_per_step", "checkpoints"}.  ``state`` replaces the
    seeded initial train state (a test carries the reference's across
    with ``training.step.train_state_from_numpy``); a resumed run
    restores into it."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_100m_ckpt"))
    ap.add_argument("--device", default="cuda",
                    help="the device to train on (default cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    api = build(CFG_100M)
    print(f"model: {CFG_100M.name}  params={CFG_100M.n_params():,}")
    oc = optim.AdamWConfig(lr=6e-4, warmup_steps=50)
    rc = step_lib.RunConfig(adamw=oc)
    step = step_lib.make_train_step(api, rc)
    pipe = TokenPipeline(DataConfig(vocab=CFG_100M.vocab, seq_len=args.seq,
                                    global_batch=args.batch, seed=0))
    mgr = CheckpointManager(args.ckpt)
    start = mgr.latest_step() or 0
    if state is None:
        state = step_lib.init_train_state(
            api, torch.Generator(device=dev).manual_seed(0), oc, device=dev)
    if start:
        state = mgr.restore(start, state, device=dev)
        print(f"resumed at step {start}")

    losses, step_s = [], []
    t0 = time.time()
    for i in range(start, args.steps):
        t1 = time.time()
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in pipe.batch(i).items()}
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        step_s.append(time.time() - t1)
        dt = time.time() - t0
        print(f"step {i:4d} loss={losses[-1]:.4f} "
              f"gnorm={float(m['grad_norm']):.2f} "
              f"tok/s={(i - start + 1) * args.batch * args.seq / dt:,.0f}")
        if (i + 1) % 50 == 0:
            mgr.save(i + 1, state, blocking=False)
    mgr.save(args.steps, state, blocking=True)
    print(f"checkpoints: {mgr.all_steps()}")
    return {"start": start, "losses": losses, "step_s": step_s,
            "tokens_per_step": args.batch * args.seq,
            "checkpoints": mgr.all_steps()}


if __name__ == "__main__":
    main()
