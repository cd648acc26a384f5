"""Quickstart: train a tiny LM end-to-end in a few seconds.

The port of ``examples/quickstart.py`` on ``repro_torch``, on the card
unless ``--device cpu`` is given: attention's forward on the
``flash_attention`` kernel and its gradient on ``flash_attention_bwd``.
Shows the full substrate in one script: config -> model -> data pipeline
(with its Clock2Q+-managed shard-index cache) -> train steps -> checkpoint
-> restore.

    PYTHONPATH=src python examples/torch/quickstart.py [--steps 20] \\
        [--smoke] [--device cpu]

``--smoke`` shrinks it to the few-second version (3 steps, tiny batch,
a temporary checkpoint directory) — same code path, just less of it.
"""

import argparse
import os
import tempfile
import time

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.models.model import build
from repro_torch.training import optim, step as step_lib


def main(argv=None, state=None) -> dict:
    """Train, save and restore; ``state`` replaces the seeded initial
    train state (a test carries the reference's across with
    ``training.step.train_state_from_numpy``).  Returns {"losses",
    "state", "restored", "ckpt_dir"}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--smoke", action="store_true",
                    help="smoke mode: 3 steps, batch 2, temp ckpt dir")
    ap.add_argument("--device", default="cuda",
                    help="the device to train on (default cuda)")
    args = ap.parse_args(argv)
    if args.smoke:
        args.steps = min(args.steps, 3)
    dev = resolve_device(args.device)

    cfg = reduced(get_config(args.arch))
    print(f"arch={cfg.name} params={cfg.n_params():,} (reduced config)")
    api = build(cfg)
    oc = optim.AdamWConfig(lr=3e-3, warmup_steps=5)
    if state is None:
        state = step_lib.init_train_state(
            api, torch.Generator(device=dev).manual_seed(0), oc, device=dev)
    step = step_lib.make_train_step(api, step_lib.RunConfig(adamw=oc))
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=64,
                                    global_batch=2 if args.smoke else 8,
                                    seed=0))
    ckpt_dir = (tempfile.mkdtemp(prefix="repro_torch_quickstart_")
                if args.smoke else os.path.join(
                    tempfile.gettempdir(), "repro_torch_quickstart_ckpt"))
    mgr = CheckpointManager(ckpt_dir)

    losses = []
    t0 = time.time()
    for i in range(args.steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in pipe.batch(i).items()}
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        if i % 5 == 0 or i == args.steps - 1:
            print(f"step {i:3d} loss={losses[-1]:.4f} "
                  f"gnorm={float(m['grad_norm']):.3f} "
                  f"index_cache_hit={pipe.index_hit_ratio:.2f} "
                  f"({time.time()-t0:.1f}s)")
    mgr.save(args.steps, state, blocking=True)
    print(f"checkpoint saved at step {mgr.latest_step()}")
    restored = mgr.restore(None, state, device=dev, verify=True)
    print("restore+verify OK")
    return {"losses": losses, "state": state, "restored": restored,
            "ckpt_dir": ckpt_dir}


if __name__ == "__main__":
    main()
