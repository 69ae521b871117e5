#!/usr/bin/env python3
"""Which collectives gloo runs on CUDA tensors of ranks that share one card.

    python3 scripts/probe_gloo_cuda_collectives.py [--ranks 4]

Each collective runs in a world of its own (``run_ranks``, gloo, every rank
on card 0), so that one that kills its ranks does not hide the others: the
blocking ``torch.distributed`` calls (all_reduce, all_gather,
all_gather_into_tensor, reduce_scatter_tensor, all_to_all_single) and the
functional ones ``DTensor`` issues (``_functional_collectives``
all_reduce, all_gather_tensor, reduce_scatter_tensor, all_to_all_single).
Prints one line a collective: ``ok`` with rank 0's first values, or how the
world failed (a rank that dies reports nothing: its exit code is printed).
Without a card the ranks run on the CPU.  On an H100 with torch 2.11 the
functional all-gather kills its ranks (exit code -11) and every other
collective here is ok, which is why a gloo mesh on the card routes that one
through ``repro_torch.parallel.collectives.shared_card_all_gather``.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

OPS = ("all_reduce", "all_gather", "all_gather_into_tensor", "reduce_scatter_tensor",
       "all_to_all_single", "functional all_reduce", "functional all_gather_tensor",
       "functional reduce_scatter_tensor", "functional all_to_all_single")


def body(world, device, op: str) -> list:
    import torch.distributed._functional_collectives as funcol
    n = world.size
    x = torch.arange(8, dtype=torch.float32, device=device) + 10 * world.rank
    group = dist.group.WORLD
    if op == "all_reduce":
        out = x.clone()
        dist.all_reduce(out)
    elif op == "all_gather":
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x)
        out = torch.cat(parts)
    elif op == "all_gather_into_tensor":
        out = x.new_empty(8 * n)
        dist.all_gather_into_tensor(out, x)
    elif op == "reduce_scatter_tensor":
        out = x.new_empty(8 // n)
        dist.reduce_scatter_tensor(out, x.clone())
    elif op == "all_to_all_single":
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.clone())
    elif op == "functional all_reduce":
        out = funcol.all_reduce(x, "sum", group)
    elif op == "functional all_gather_tensor":
        out = funcol.all_gather_tensor(x, 0, group)
    elif op == "functional reduce_scatter_tensor":
        out = funcol.reduce_scatter_tensor(x, "sum", 0, group)
    else:
        out = funcol.all_to_all_single(x, None, None, group)
    return torch.as_tensor(out).flatten()[:4].cpu().tolist()


def main() -> int:
    from repro_torch.parallel.data import run_ranks
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    args = ap.parse_args()
    on_card = torch.cuda.is_available()
    print(f"torch {torch.__version__}, {'card 0' if on_card else 'CPU'}, {args.ranks} gloo ranks",
          flush=True)
    for op in OPS:
        try:
            res = run_ranks(body, args.ranks, backend="gloo", device=None if on_card else "cpu",
                            share_device=on_card, timeout_s=120, args=(op,))
            print(f"{op:34s} ok {res[0]}", flush=True)
        except Exception as e:     # the probe reports every collective, failing or not
            line = str(e).strip().splitlines()
            print(f"{op:34s} FAILED {type(e).__name__}: {line[0] if line else ''}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
