#!/usr/bin/env python3
"""``chip_smoke.py``'s ``moe_main`` serving run under two layouts of the
moe router's rank scan, in turns old, new, new, old on one card.

    python3 tools/moe_route_ab.py      # from the repository root, on the card

old: a (T*K, E) int64 one-hot scanned down its T*K axis (E sequential
scans); new: ``models/moe.py``'s expert-major int32 one-hot scanned
along its rows.  Both give the same ranks, so every request's tokens
must be equal.  Prints one JSON line a run (decode and prefill ms
p50, tokens/s, ``moe_stage_ms`` at T 8 and 1,536) and the equality.
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)
import torch
import torch.nn.functional as F
import chip_smoke as cs
from repro_torch.configs import get_config
from repro_torch.kernels import build as kbuild
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.paged_attention import ops as pops
from repro_torch.models import layers as L
from repro_torch.models import moe as M

NEW_ROUTE = M.route


def old_route(cfg, p, xf, decode=False):
    """``M.route`` with the (T*K, E) one-hot scanned down T*K."""
    T, E, K = xf.shape[0], cfg.n_experts, cfg.experts_per_tok
    probs = torch.softmax(xf.float() @ p["router"], dim=-1)
    gates, eidx = torch.topk(probs, K, dim=-1, sorted=True)
    gates = gates / gates.sum(-1, keepdim=True)
    flat_e = eidx.reshape(-1)
    onehot = F.one_hot(flat_e, E)
    ranks = torch.cumsum(onehot, dim=0) - onehot
    pos = ranks.gather(1, flat_e[:, None])[:, 0]
    C = M._capacity(cfg, T, decode)
    return M.Routing(probs, eidx, gates, pos, pos < C, C)


def main() -> int:
    """Run old, new, new, old; returns 0 if the tokens are equal."""
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kbuild.build_many([("flash_attention", fops.SOURCE),
                       ("paged_attention", pops.SOURCE)])
    cfg = get_config("olmoe-1b-7b")
    api, params, *_ = cs._init_model(dev, cfg)
    p0 = L.layer(params["blocks"], 0)["moe"]
    tokens = {}
    for name in ("old", "new", "new", "old"):
        M.route = old_route if name == "old" else NEW_ROUTE
        reqs = cs.make_requests(32, seed=0, vocab=cfg.vocab)
        eng, outs, rec, wall, launches = cs.serve_run(dev, api, params, reqs)
        m = cs.serve_metrics(dev, eng, outs, rec, wall)
        got = {c.req_id: c.tokens for c in outs}
        tokens.setdefault(name, got)
        stages = [cs.moe_stage_ms(dev, cfg, p0, T, T <= 8)
                  for T in cs.MOE_STAGE_T]
        cs.emit(dict(route=name, wall_s=wall,
                     decode_p50=m["decode_step_ms_p50"],
                     decode_p99=m["decode_step_ms_p99"],
                     prefill_p50=m["prefill_ms_p50"],
                     tokens_per_s=m["output_tokens_per_s"],
                     launches=launches, moe_stage_ms=stages))
        del eng
    same = tokens["old"] == tokens["new"]
    cs.emit(dict(tokens_equal=same))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
