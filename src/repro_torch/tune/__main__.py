"""``python -m repro_torch.tune`` — manage the persistent tuning cache.

Subcommands (the reference's, with its flags and printed lines):

  populate  measure the cells on this machine's configured device (the
            card unless ``REPRO_TORCH_DEVICE=cpu``) and persist the winners
            (``--kernels``, ``--shapes NxD[xK]`` or named dims,
            ``--repeats``, ``--dtype``, ``--verbose``)
  show      print every cache entry (``--kernel`` / ``--device-kind``)
  prune     drop stale entries (``--max-age-days``) and/or everything for
            a device kind or kernel
  clear     empty the cache

``--cache PATH`` (or ``$REPRO_TORCH_TUNE_CACHE``) selects the file; the
default is ``~/.cache/repro_torch/tune_cache.json``. The reference's
``--include-pallas`` has no counterpart: on the card the CUDA routes are
always the candidates, on the CPU the plain versions.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from repro_torch.tune.cache import TuningCache, default_cache_path


def _parse_shapes(spec: str) -> List[dict]:
    """Two spellings, comma-separated: positional ``8192x8[x3]`` →
    ``{"n": 8192, "d": 8, "k": 3}``; named ``n8192:m512:d8`` → any bucket
    dim (``m``, ``s``, ``nq``, ``p``, ...)."""
    out = []
    for part in spec.split(","):
        part = part.strip().lower()
        if not part:
            continue
        if part[0].isalpha() or ":" in part:
            dims = {}
            for item in part.split(":"):
                name = item.rstrip("0123456789")
                if not name or name == item:
                    raise SystemExit(
                        f"--shapes: bad named dim {item!r} in {part!r} "
                        f"(want e.g. n8192:m512:d8)")
                dims[name] = int(item[len(name):])
            out.append(dims)
        else:
            vals = [int(v) for v in part.split("x")]
            names = ("n", "d", "k")[: len(vals)]
            out.append(dict(zip(names, vals, strict=False)))  # >3 dims: extras dropped
    return out


def _cmd_populate(args) -> int:
    from repro_torch.tune.autotune import DEFAULT_DIMS, KERNELS, autotune_cell

    cache = TuningCache(args.cache)
    kernels = ([k.strip() for k in args.kernels.split(",") if k.strip()]
               if args.kernels else list(KERNELS))
    shapes = _parse_shapes(args.shapes) if args.shapes else [None]
    for kernel in kernels:
        if kernel not in KERNELS:
            print(f"unknown kernel {kernel!r}; have {list(KERNELS)}",
                  file=sys.stderr)
            return 2
        for dims in shapes:
            cell_dims = dims
            if dims is not None:
                # keep only the dims this cell is bucketed by, and say so
                # when a requested dim does not apply
                cell_dims = {k: v for k, v in dims.items()
                             if k in DEFAULT_DIMS[kernel]}
                dropped = sorted(set(dims) - set(cell_dims))
                defaulted = sorted(set(DEFAULT_DIMS[kernel]) - set(cell_dims))
                if dropped or defaulted:
                    print(f"# note: {kernel} is bucketed on "
                          f"{sorted(DEFAULT_DIMS[kernel]) or 'no dims'}"
                          + (f"; ignoring {dropped} from --shapes"
                             if dropped else "")
                          + (f"; using built-in defaults for {defaulted}"
                             if defaulted else ""),
                          file=sys.stderr)
                cell_dims = {**DEFAULT_DIMS[kernel], **cell_dims}
            params, sec = autotune_cell(
                kernel, cell_dims, dtype=args.dtype, cache=cache,
                repeats=args.repeats, verbose=args.verbose)
            print(f"# tuned {kernel} dims={cell_dims or 'default'} -> "
                  f"{params} ({sec * 1e3:.3f} ms median)", flush=True)
    print(f"# cache: {cache.path} ({len(cache)} entries)", flush=True)
    return 0


def _cmd_show(args) -> int:
    cache = TuningCache(args.cache)
    shown = 0
    print(f"# tuning cache {cache.path}")
    for (dk, kernel, bucket, dtype), rec in cache.entries():
        if args.kernel and kernel != args.kernel:
            continue
        if args.device_kind and dk != args.device_kind:
            continue
        sec = rec.get("seconds")
        ms = f"{sec * 1e3:.3f} ms" if sec is not None else "-"
        print(f"{dk} | {kernel} | {bucket} | {dtype} -> {rec['params']} "
              f"({ms}, {rec.get('candidates', 0)} candidates)")
        shown += 1
    print(f"# {shown} of {len(cache)} entries shown")
    return 0


def _cmd_prune(args) -> int:
    cache = TuningCache(args.cache)
    if args.max_age_days is None and not args.device_kind and not args.kernel:
        print("prune needs --max-age-days and/or --device-kind/--kernel "
              "(use clear to drop everything)", file=sys.stderr)
        return 2
    n = cache.prune(max_age_days=args.max_age_days,
                    device_kind=args.device_kind or None,
                    kernel=args.kernel or None)
    print(f"# pruned {n} entries; {len(cache)} remain in {cache.path}")
    return 0


def _cmd_clear(args) -> int:
    cache = TuningCache(args.cache)
    n = cache.clear()
    print(f"# cleared {n} entries from {cache.path}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tune",
        description="manage the persistent kernel-tuning cache of the "
                    "PyTorch/CUDA port (the reference's --include-pallas has "
                    "no counterpart: the card's candidates are its CUDA "
                    "routes, the CPU's the plain versions)")
    ap.add_argument("--cache", default=None,
                    help=f"cache file (default {default_cache_path()})")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("populate", help="measure cells, persist winners")
    p.add_argument("--kernels", default="",
                   help="comma list (default: every registered cell)")
    p.add_argument("--shapes", default="",
                   help="comma list of synthetic shapes: NxD[xK] "
                        "positional, or named dims like n8192:m512:d8 "
                        "or nq1024:p8192:d8 for cells bucketed on "
                        "m/s/nq/p (default: one built-in shape per cell)")
    p.add_argument("--repeats", type=int, default=3,
                   help="timed runs per candidate (median taken)")
    p.add_argument("--dtype", default="float32",
                   help="element type to measure and key the cells with "
                        "(runtime lookups key by the data's actual dtype)")
    p.add_argument("--verbose", action="store_true")
    p.set_defaults(fn=_cmd_populate)

    p = sub.add_parser("show", help="print cache entries")
    p.add_argument("--kernel", default="")
    p.add_argument("--device-kind", default="")
    p.set_defaults(fn=_cmd_show)

    p = sub.add_parser("prune", help="drop stale/filtered entries")
    p.add_argument("--max-age-days", type=float, default=None)
    p.add_argument("--device-kind", default="")
    p.add_argument("--kernel", default="")
    p.set_defaults(fn=_cmd_prune)

    p = sub.add_parser("clear", help="empty the cache")
    p.set_defaults(fn=_cmd_clear)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
