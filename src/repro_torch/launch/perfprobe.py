"""Perf probe of one dry-run cell (``repro.launch.perfprobe``): the three
roofline terms, per-device memory and collectives, then the module scopes
that move the most bytes.

    PYTHONPATH=src python -m repro_torch.launch.perfprobe --arch qwen3-32b \\
        [--shape train_4k] [--multi] [--top 8] [--detail 4]

The reference ranks HLO computations by bytes x loop trips; the port ranks
the scopes of its traced step (:mod:`repro_torch.launch.dryrun`): a scope is
the innermost function of the models or kernels an operation ran in, under
the model loops it ran in (``layers.*.mlp.mlp_forward``); its trips are the
count of loop iterations (layers) it ran in, and the backward pass is one
scope.  ``--detail N`` adds the N largest tensors each top scope wrote.
Like the dry run it needs no card and its numbers are a model at the H100's
published peaks.
"""

from __future__ import annotations

import argparse

from .dryrun import lower_cell

__all__ = ["scope_rows", "probe", "main"]


def scope_rows(trace) -> list:
    """(bytes, flops, trips, scope, largest outputs) of every scope of a
    dry-run trace, most bytes first."""
    rows = [(b, f, max(1, len(iters)), name, sorted(big, reverse=True))
            for name, (b, f, iters, big) in trace.scopes.items()]
    return sorted(rows, key=lambda r: -r[0])


def probe(arch: str, shape: str = "train_4k", multi: bool = False, smoke: bool = False):
    """(the dry run's record of the cell, its scope rows)."""
    rec, trace = lower_cell(arch, shape, multi, return_trace=True, smoke=smoke)
    return rec, ([] if trace is None else scope_rows(trace))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--multi", action="store_true")
    ap.add_argument("--top", type=int, default=8)
    ap.add_argument("--detail", type=int, default=0,
                    help="print the N largest tensors each top scope wrote")
    ap.add_argument("--smoke", action="store_true", help="the arch's SMOKE config")
    args = ap.parse_args(argv)

    rec, rows = probe(args.arch, args.shape, args.multi, args.smoke)
    if rec["status"] != "ok":
        print(rec)
        return 1
    r = rec["roofline"]
    print(f"== {args.arch} {args.shape} {'multi' if args.multi else 'single'} "
          "(a model at the H100's published peaks, not a measurement) ==")
    print(f"compute {r['compute_s']:.3f}s | memory {r['memory_s']:.3f}s | "
          f"collective {r['collective_s']:.3f}s | dom={r['dominant']} | "
          f"mfu_bound={r['mfu_bound']:.4f} | ratio={r['model_flops_ratio']:.3f}")
    c = rec["cost"]
    print(f"mem/dev: {rec['memory']['peak_estimate_bytes'] / 2**30:.2f} GiB  "
          f"colls: { {k: int(v) for k, v in c['collective_counts'].items()} }")
    print(f"coll GB: { {k: round(v / 1e9, 1) for k, v in c['collective_bytes_by_kind'].items()} }")
    print("\ntop scopes (bytes, x trips):")
    for nbytes, flops, trips, name, big in rows[: args.top]:
        print(f"  {nbytes:11.3e}  x{trips:5d}  {name}  ({flops:.3e} flops)")
        for b, op, shapes in big[: args.detail]:
            print(f"      {b:10.2e} {op:24s} {shapes}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
