"""Build the ``index.csv`` that ``data/datasets.Sen2VenusDataset`` reads from
a tree of Sen2Venus tile pairs (the counterpart of the JAX package's
``scripts/make_index.py``, reading tiles through the port's own codec).

It walks ``root``, pairs every ``*_10m*`` GeoTIFF with its ``*_05m*``
sibling (the same name otherwise) and writes the tab-separated index
(columns ``b2b3b4b8_10m`` / ``b2b3b4b8_05m``) with paths relative to
``root``, sorted. LR tiles without a sibling are reported on stderr and
left out. ``--validate`` opens every pair through ``data/tiffio`` and
checks the 2x geometry (HR = 2 x LR, the same band count): any invalid pair
is reported, and then no index is written. Exit code 1 with no pairs or an
invalid one, else 0.

    python -m simple_vae_rs_tpu_torch.make_index /data/ARM [--validate] [--dry_run]
"""

from __future__ import annotations

import argparse
import csv
import os
import sys
from typing import List, Optional, Sequence, Tuple

LR_COL = "b2b3b4b8_10m"
HR_COL = "b2b3b4b8_05m"
_TIFF_EXT = (".tif", ".tiff")


def find_pairs(root: str) -> Tuple[List[Tuple[str, str]], List[str]]:
    """Sorted (lr_rel, hr_rel) pairs and the sorted dangling LR tiles."""
    root = os.path.abspath(root)
    pairs, dangling = [], []
    for dirpath, _dirs, files in os.walk(root):
        present = set(files)
        rel = os.path.relpath(dirpath, root)
        for name in files:
            if not name.lower().endswith(_TIFF_EXT) or "_10m" not in name:
                continue
            hr_name = name.replace("_10m", "_05m")
            lr_rel = name if rel == "." else os.path.join(rel, name)
            if hr_name in present:
                pairs.append((lr_rel, hr_name if rel == "." else os.path.join(rel, hr_name)))
            else:
                dangling.append(lr_rel)
    pairs.sort()
    dangling.sort()
    return pairs, dangling


def validate_pair(root: str, lr_rel: str, hr_rel: str) -> str:
    """'' when the pair is sound, else a one-line description of the problem."""
    from simple_vae_rs_tpu_torch.data.datasets import _to_hwc
    from simple_vae_rs_tpu_torch.data.tiffio import read_tiff

    try:
        lr = _to_hwc(read_tiff(os.path.join(root, lr_rel)))
        hr = _to_hwc(read_tiff(os.path.join(root, hr_rel)))
    except Exception as exc:  # a corrupt or unsupported tile, reported by name
        return f"{lr_rel}: {type(exc).__name__}: {exc}"
    if (hr.shape[0], hr.shape[1]) != (2 * lr.shape[0], 2 * lr.shape[1]):
        return f"{lr_rel}: HR {hr.shape[:2]} is not 2x LR {lr.shape[:2]}"
    if hr.shape[2] != lr.shape[2]:
        return f"{lr_rel}: band mismatch LR {lr.shape[2]} vs HR {hr.shape[2]}"
    return ""


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m simple_vae_rs_tpu_torch.make_index",
        description="index a Sen2Venus tile tree for Sen2VenusDataset")
    ap.add_argument("root", help="dataset root (index.csv is written here)")
    ap.add_argument("--validate", action="store_true",
                    help="open every pair and check the 2x geometry")
    ap.add_argument("--dry_run", action="store_true",
                    help="report what would be written, write nothing")
    args = ap.parse_args(argv)

    pairs, dangling = find_pairs(args.root)
    for rel in dangling:
        print(f"skipping {rel}: no _05m sibling", file=sys.stderr)
    if not pairs:
        print(f"no *_10m*/*_05m* tile pairs under {args.root}", file=sys.stderr)
        return 1
    if args.validate:
        bad = 0
        for lr_rel, hr_rel in pairs:
            problem = validate_pair(args.root, lr_rel, hr_rel)
            if problem:
                print(f"invalid pair: {problem}", file=sys.stderr)
                bad += 1
        if bad:
            print(f"{bad} invalid pair(s) — index not written", file=sys.stderr)
            return 1
    out = os.path.join(os.path.abspath(args.root), "index.csv")
    print(f"{len(pairs)} pair(s) -> {out}" + (" (dry run)" if args.dry_run else ""))
    if args.dry_run:
        return 0
    with open(out, "w", newline="") as fh:
        w = csv.writer(fh, delimiter="\t")
        w.writerow([LR_COL, HR_COL])
        w.writerows(pairs)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
