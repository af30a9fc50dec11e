"""Score a super-resolved raster against its ground truth (the port's copy of
the JAX package's ``evaluate.py``).

    python -m simple_vae_rs_tpu_torch.evaluate sr.tif truth.tif [--lr lr.tif] \\
        [--stream] [--backend cpu]

It reports the metric family training logs: PSNR, SSIM, LPIPS where its
weights are on disk, and with ``--lr`` the bicubic baseline's rows. Both
rasters are mapped to [0, 1] by the truth's per-channel min-max (the
normalization the model trains against), and PSNR/SSIM use ``data_range=1``
there, as the trainer's validation metrics do; RMSE is also given in the
input's units. LPIPS runs over a window grid and is averaged. ``--stream``
scores in bounded memory through ``TiffReader.read_rows``: PSNR and RMSE
exact, SSIM and LPIPS averaged over a ``--win`` window grid (equal to the
in-memory value where one window covers the raster). The metrics run on the
CUDA card unless ``--backend cpu``. The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from simple_vae_rs_tpu_torch.data.tiffio import TiffReader, read_tiff
from simple_vae_rs_tpu_torch.ops.metrics import psnr, ssim
from simple_vae_rs_tpu_torch.ops.resize import bicubic_upsample_2x
from simple_vae_rs_tpu_torch.serve import backend_device, resolve_device
from simple_vae_rs_tpu_torch.utils import lpips_optional

_EPS = 1e-5  # as utils.image.normalize_image


def _to_hwc(arr: np.ndarray, channels: Optional[int]) -> Tuple[np.ndarray, str]:
    """A raster as (H, W, C) plus its layout tag. ``read_tiff`` gives (H, W),
    (H, W, C) or (C, H, W); ``channels`` tells the last two apart, else the
    small-axis rule does."""
    if arr.ndim == 2:
        return arr[:, :, None], "hw"
    if arr.ndim != 3:
        raise ValueError(f"expected a 2-D or 3-D raster, got shape {arr.shape}")
    first, last = arr.shape[0], arr.shape[-1]
    if channels is not None and (first == channels) != (last == channels):
        chw = first == channels
    else:
        chw = first <= 16 < last
    return (np.moveaxis(arr, 0, -1), "chw") if chw else (arr, "hwc")


def grid_starts(size: int, patch: int, stride: int) -> List[int]:
    """Window starts covering ``[0, size)``, the last one flush to the edge."""
    if patch <= 0 or stride <= 0:
        raise ValueError(f"patch and stride must be positive (got {patch}, {stride})")
    if patch > size:
        raise ValueError(f"patch {patch} exceeds image extent {size}")
    starts = list(range(0, size - patch + 1, stride))
    if starts[-1] != size - patch:
        starts.append(size - patch)
    return starts


def _load_hwc(path: str, channels: Optional[int]):
    arr = read_tiff(path)
    hwc, _layout = _to_hwc(arr, channels)
    return np.asarray(hwc, np.float32), arr.dtype


def _truth_norm(truth: np.ndarray):
    """The truth's per-channel min and range: the evaluation domain, so the
    score does not depend on the product's radiometric scale."""
    mn = truth.min(axis=(0, 1), keepdims=True)
    denom = truth.max(axis=(0, 1), keepdims=True) - mn + _EPS
    return mn, denom


def _t(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)


def _lpips_values(wa: np.ndarray, wb: np.ndarray, params, device) -> Optional[np.ndarray]:
    if params is None:
        return None
    vals = lpips_optional.lpips_batch(_t(wa, device), _t(wb, device), params)
    return None if vals is None else vals.cpu().numpy()


def _lpips_windowed(a: np.ndarray, b: np.ndarray, params, device, win: int = 64):
    """Mean LPIPS over a ``win``-px window grid (tails flush to the edge), or
    None without weights."""
    h, w = a.shape[:2]
    win = min(win, h, w)
    wins_a, wins_b = [], []
    for sh in grid_starts(h, win, win):
        for sw in grid_starts(w, win, win):
            wins_a.append(a[sh:sh + win, sw:sw + win])
            wins_b.append(b[sh:sh + win, sw:sw + win])
    vals = _lpips_values(np.stack(wins_a), np.stack(wins_b), params, device)
    return float(np.mean(vals)) if vals is not None else None


def evaluate_product(sr: np.ndarray, truth: np.ndarray, lr: Optional[np.ndarray] = None,
                     device="cuda") -> Dict[str, Optional[float]]:
    """The metrics of (H, W, C) float32 rasters; ``lr`` (H/2, W/2, C) adds the
    bicubic baseline's rows."""
    dev = resolve_device(device)
    if sr.shape != truth.shape:
        raise ValueError(f"product {sr.shape} and truth {truth.shape} differ in shape")
    mn, denom = _truth_norm(truth)
    # a product already in [0, 1] (the model's own output range) is scored
    # as it is
    unit = float(sr.max()) <= 1.0 + 1e-6 and float(sr.min()) >= -1e-6 \
        and float(truth.max()) > 2.0
    sr_n = sr if unit else (sr - mn) / denom
    truth_n = (truth - mn) / denom
    params = lpips_optional.load(dev)
    a, b = _t(sr_n, dev)[None], _t(truth_n, dev)[None]
    out: Dict[str, Optional[float]] = {
        "psnr": float(psnr(a, b)[0]),
        "ssim": float(ssim(a, b)[0]),
        "rmse_input_units": float(np.sqrt(np.mean((sr_n * denom - truth_n * denom) ** 2))),
        "lpips": _lpips_windowed(sr_n, truth_n, params, dev),
    }
    if lr is not None:
        if lr.shape[:2] != (truth.shape[0] // 2, truth.shape[1] // 2):
            raise ValueError(f"LR {lr.shape} is not half the truth's extent {truth.shape}")
        lr_n = (lr - mn) / denom
        up = bicubic_upsample_2x(_t(lr_n, dev)[None])[0].cpu().numpy()
        # odd truth extents: the baseline covers 2 * (extent // 2) rows
        bh, bw = up.shape[0], up.shape[1]
        u, bt = _t(up, dev)[None], _t(truth_n[:bh, :bw], dev)[None]
        out["psnr_baseline"] = float(psnr(u, bt)[0])
        out["ssim_baseline"] = float(ssim(u, bt)[0])
        out["lpips_baseline"] = _lpips_windowed(up, truth_n[:bh, :bw], params, dev)
    return out


def _open_reader(path: str):
    """(reader, to_hwc, H, W, C) for strip-windowed scoring."""
    r = TiffReader(path)
    c = 1 if r.layout == "hw" else r.samples_per_pixel
    return r, r.to_hwc, r.height, r.width, c


def _stream_stats(reader, to_hwc, block_rows: int):
    """Per-channel finite min and max of a raster, in row blocks."""
    mn = mx = None
    for r0 in range(0, reader.height, block_rows):
        r1 = min(reader.height, r0 + block_rows)
        blk = to_hwc(reader.read_rows(r0, r1)).astype(np.float32)
        safe = np.where(np.isfinite(blk), blk, np.nan)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)  # all-NaN blocks
            bmn = np.nanmin(safe, axis=(0, 1))
            bmx = np.nanmax(safe, axis=(0, 1))
        mn = bmn if mn is None else np.fmin(mn, bmn)
        mx = bmx if mx is None else np.fmax(mx, bmx)
    mn = np.where(np.isfinite(mn), mn, 0.0).astype(np.float32)
    mx = np.where(np.isfinite(mx), mx, 0.0).astype(np.float32)
    return mn, mx


def evaluate_product_streamed(product_path: str, truth_path: str,
                              lr_path: Optional[str] = None, win: int = 64,
                              device="cuda") -> Dict[str, Optional[float]]:
    """Bounded-memory scoring: a sweep of ``win``-row bands read with
    ``TiffReader.read_rows``. PSNR and RMSE are exact (squared errors over
    the rows, the flush tail band counted once); SSIM and LPIPS are averaged
    over a ``win``-px window grid (equal to the whole-raster value where one
    window covers the raster). The bicubic baseline reads each LR band with a
    2-px halo (the cubic kernel's reach), so a band's upsample equals the
    whole raster's there. Peak memory is O(win x width)."""
    dev = resolve_device(device)
    rp, to_p, ph, pw, pc = _open_reader(product_path)
    rt, to_t, h, w, c = _open_reader(truth_path)
    if (ph, pw, pc) != (h, w, c):
        raise ValueError(f"product {(ph, pw, pc)} and truth {(h, w, c)} differ in shape")
    rl = None
    if lr_path:
        rl, to_l, lh, lw, lc = _open_reader(lr_path)
        if (lh, lw, lc) != (h // 2, w // 2, c):
            raise ValueError(f"LR {(lh, lw, lc)} is not half the truth's extent {(h, w, c)}")
    win = min(win, h, w)
    params = lpips_optional.load(dev)

    # pass 1: the truth's range (the metric domain) and the product's (is it
    # in [0, 1] already?)
    tmn, tmx = _stream_stats(rt, to_t, max(rt.rows_per_strip, 256))
    pmn, pmx = _stream_stats(rp, to_p, max(rp.rows_per_strip, 256))
    unit = float(pmx.max()) <= 1.0 + 1e-6 and float(pmn.min()) >= -1e-6 \
        and float(tmx.max()) > 2.0
    mn = tmn[None, None]
    denom = (tmx[None, None] - mn) + _EPS

    se_n = se_in = 0.0          # normalized / input-unit squared error
    ssim_sum, n_win = 0.0, 0
    lp_sum, lp_n = 0.0, 0
    bse_n, b_px, b_counted = 0.0, 0, 0
    bssim_sum, bn_win = 0.0, 0
    blp_sum, blp_n = 0.0, 0
    counted = 0                  # truth rows already in the squared-error sums
    bh, bw = 2 * (h // 2), 2 * (w // 2)  # the baseline's rows and columns
    for rs in grid_starts(h, win, win):
        p_rows = to_p(rp.read_rows(rs, rs + win)).astype(np.float32)
        t_rows = to_t(rt.read_rows(rs, rs + win)).astype(np.float32)
        p_n = p_rows if unit else (p_rows - mn) / denom
        t_n = (t_rows - mn) / denom
        new0 = max(0, counted - rs)  # the flush tail band overlaps
        d = p_n[new0:] - t_n[new0:]
        se_n += float(np.sum(d * d))
        din = d * denom
        se_in += float(np.sum(din * din))
        counted = rs + win
        cols = grid_starts(w, win, win)
        wa = np.stack([p_n[:, cs:cs + win] for cs in cols])
        wb = np.stack([t_n[:, cs:cs + win] for cs in cols])
        ssim_sum += float(ssim(_t(wa, dev), _t(wb, dev)).sum())
        n_win += len(cols)
        lv = _lpips_values(wa, wb, params, dev)
        if lv is not None:
            lp_sum += float(np.sum(lv))
            lp_n += len(lv)
        if rl is not None and rs < bh:
            # the LR band with the cubic kernel's 2-px halo; on odd heights
            # the last band is clipped to the baseline's rows
            be = min(rs + win, bh)
            lo = max(0, rs // 2 - 2)
            hi = min(h // 2, (be - 1) // 2 + 3)
            lr_rows = to_l(rl.read_rows(lo, hi)).astype(np.float32)
            lr_n = (lr_rows - mn) / denom
            up = bicubic_upsample_2x(_t(lr_n, dev)[None])[0].cpu().numpy()
            band = up[rs - 2 * lo: rs - 2 * lo + (be - rs), :bw]
            tb = t_n[:be - rs, :bw]
            nb = max(0, b_counted - rs)  # the flush tail band overlaps
            db = band[nb:] - tb[nb:]
            bse_n += float(np.sum(db * db))
            b_px += db.size
            b_counted = be
            bcols = grid_starts(bw, win, win)
            ba = np.stack([band[:, cs:cs + win] for cs in bcols])
            bb = np.stack([tb[:, cs:cs + win] for cs in bcols])
            bssim_sum += float(ssim(_t(ba, dev), _t(bb, dev)).sum())
            bn_win += len(bcols)
            blv = _lpips_values(ba, bb, params, dev)
            if blv is not None:
                blp_sum += float(np.sum(blv))
                blp_n += len(blv)
    rp.close()
    rt.close()
    if rl is not None:
        rl.close()

    n_px = float(h * w * c)
    out: Dict[str, Optional[float]] = {
        "psnr": float(10.0 * np.log10(1.0 / max(se_n / n_px, 1e-12))),
        "ssim": ssim_sum / max(n_win, 1),
        "rmse_input_units": float(np.sqrt(se_in / n_px)),
        "lpips": (lp_sum / lp_n) if lp_n else None,
    }
    if rl is not None:
        out["psnr_baseline"] = float(10.0 * np.log10(1.0 / max(bse_n / max(b_px, 1), 1e-12)))
        out["ssim_baseline"] = bssim_sum / max(bn_win, 1)
        out["lpips_baseline"] = (blp_sum / blp_n) if blp_n else None
    return out


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m simple_vae_rs_tpu_torch.evaluate",
        description="Score an SR raster against ground truth (PSNR/SSIM/LPIPS in "
        "training's [0,1] metric domain; optional bicubic-baseline rows from the LR input).")
    p.add_argument("product", help="SR raster to score")
    p.add_argument("truth", help="ground-truth HR raster")
    p.add_argument("--lr", default=None,
                   help="the LR input raster: adds the bicubic baseline's PSNR/SSIM/LPIPS")
    p.add_argument("--channels", type=int, default=None,
                   help="band count (tells (C,H,W) from (H,W,C); default: small-axis rule)")
    p.add_argument("--stream", action="store_true",
                   help="bounded-memory scoring: strip-windowed reads, exact PSNR/RMSE, "
                   "SSIM/LPIPS averaged over a --win window grid")
    p.add_argument("--win", type=int, default=64,
                   help="window size of the streamed SSIM/LPIPS grid (default 64)")
    p.add_argument("--backend", default="",
                   help="'cpu' scores on the host; the default runs on the CUDA card")
    args = p.parse_args(argv)
    backend = backend_device(args.backend)

    if args.stream:
        out = evaluate_product_streamed(args.product, args.truth, lr_path=args.lr,
                                        win=args.win, device=backend)
    else:
        sr, _ = _load_hwc(args.product, args.channels)
        truth, _ = _load_hwc(args.truth, args.channels)
        lr = _load_hwc(args.lr, args.channels)[0] if args.lr else None
        out = evaluate_product(sr, truth, lr=lr, device=backend)

    print(f"product: {os.path.abspath(args.product)}")
    print(f"truth:   {os.path.abspath(args.truth)}")
    print(f"  PSNR  {out['psnr']:.2f} dB"
          + (f"   (bicubic {out['psnr_baseline']:.2f})" if "psnr_baseline" in out else ""))
    print(f"  SSIM  {out['ssim']:.4f}"
          + (f"      (bicubic {out['ssim_baseline']:.4f})" if "ssim_baseline" in out else ""))
    if out["lpips"] is not None:
        print(f"  LPIPS {out['lpips']:.4f}"
              + (f"     (bicubic {out['lpips_baseline']:.4f})"
                 if out.get("lpips_baseline") is not None else ""))
    else:
        print("  LPIPS skipped (no weights on disk — see doctor)", file=sys.stderr)
    print(f"  RMSE  {out['rmse_input_units']:.3f} (input units)")
    print(json.dumps({"metric": "product_eval", **{
        k: (round(v, 6) if isinstance(v, float) else v) for k, v in out.items()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
