"""Production-style training launcher, one device.

The port of ``repro.launch.train``, with its flags, plus ``--device``
(``cuda`` unless named): resume from the latest checkpoint, a retried
step, a periodic asynchronous save, the deterministic restart-safe data
pipeline (``data.pipeline.TokenPipeline``).  It trains on one device,
as the reference's launcher does; the same ``make_train_step`` takes a
state and batch sharded over a ``launch.mesh`` mesh (DTensors placed by
``sharding.rules``), and ``chip_smoke.py``'s ``mesh_train`` drives it.
``main(argv)``
takes the arguments as a list, so a script can call it in process, and
returns the final train state, the step it started from and each
step's loss.

    PYTHONPATH=src python -m repro_torch.launch.train --steps 6 \\
        --ckpt DIR [--device cpu] [--full-config]
"""

from __future__ import annotations

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


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--full-config", action="store_true",
                    help="use the full architecture config")
    ap.add_argument("--device", default="cuda",
                    help="the device to train on (default cuda)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full_config:
        cfg = reduced(cfg)
    api = build(cfg)
    print(f"arch={cfg.name} params={cfg.n_params():,} device={dev}")

    oc = optim.AdamWConfig(lr=args.lr, warmup_steps=10)
    rc = step_lib.RunConfig(microbatches=args.microbatches, adamw=oc)
    step_fn = step_lib.make_train_step(api, rc)
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                    global_batch=args.batch, seed=0))
    mgr = CheckpointManager(args.ckpt)

    start = mgr.latest_step() or 0
    gen = torch.Generator(device=dev).manual_seed(0)
    state = step_lib.init_train_state(api, gen, oc, device=dev)
    if start:
        state = mgr.restore(start, state, device=dev)
        print(f"resumed from step {start}")

    losses = []
    t0 = time.time()
    for i in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in pipe.batch(i).items()}
        for attempt in range(3):  # straggler/failure retry
            try:
                state, m = step_fn(state, batch)
                break
            except Exception as e:  # noqa: BLE001
                print(f"step {i} attempt {attempt} failed: {e!r}")
                if attempt == 2:
                    raise
        losses.append(m["loss"])
        if i % 10 == 0 or i == args.steps - 1:
            tok_s = args.batch * args.seq * (i - start + 1) \
                / max(1e-9, time.time() - t0)
            print(f"step {i:4d} loss={float(m['loss']):.4f} "
                  f"lr={float(m['lr']):.2e} tok/s={tok_s:,.0f} "
                  f"idx_cache_hit={pipe.index_hit_ratio:.2f}")
        if (i + 1) % args.ckpt_every == 0:
            mgr.save(i + 1, state, blocking=False)
    mgr.save(args.steps, state, blocking=True)
    print(f"done; checkpoints: {mgr.all_steps()}")
    return {"state": state, "start": start,
            "losses": [float(x) for x in losses]}


if __name__ == "__main__":
    main()
