"""One SMOKE config's FLOPs as the port's dry-run counts them
(``torch.utils.flop_counter.FlopCounterMode``: matmul-class ops only)
beside the JAX package's count for the same step (XLA's ``cost_analysis``
of the jitted forward and backward: every op), on the CPU:

    PYTHONPATH=src python tools/dryrun_flops_vs_xla.py [--arch gpt2_medium] [--remat]

One microbatch of B x S tokens through ``loss_fn`` and its gradient, the
reference's ``remat`` / the port's alike, the reference's layers unrolled.
Prints one JSON line.
"""

import argparse
import json

import jax
import jax.numpy as jnp
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import load_arch as j_load_arch
from repro.models import transformer as JT
from repro_torch.configs import load_arch
from repro_torch.models import transformer as T


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt2_medium")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--remat", action="store_true")
    args = ap.parse_args()
    jcfg, cfg = j_load_arch(args.arch).SMOKE, load_arch(args.arch).SMOKE
    B, S = args.batch, args.seq

    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    jb = {"tokens": jnp.zeros((B, S), jnp.int32)}
    # unroll: XLA's cost_analysis counts a scan's body once whatever its trip
    # count (the reference's own reason for the keyword)
    step = jax.jit(jax.value_and_grad(lambda p: JT.loss_fn(p, jb, jcfg, remat=args.remat,
                                                           unroll=True)))
    cost = step.lower(jp).compile().cost_analysis()
    cost = cost[0] if isinstance(cost, list) else cost

    lay = T.layout(cfg)
    flat = lay.empty(device="meta")
    leaves = lay.autograd_leaves(flat, torch.empty_like(flat))
    with FlopCounterMode(display=False) as fc:
        loss = T.loss_fn(leaves, {"tokens": torch.zeros((B, S), dtype=torch.long,
                                                        device="meta")}, cfg,
                         remat=args.remat)
        loss.backward()
    ours = fc.get_total_flops()
    print(json.dumps({"arch": f"{args.arch}_smoke", "batch": B, "seq": S, "remat": args.remat,
                      "flop_counter_mode": ours, "xla_cost_analysis": float(cost["flops"]),
                      "ratio": ours / float(cost["flops"])}))


if __name__ == "__main__":
    main()
