"""Whole-raster SR command: GeoTIFF in, super-resolved GeoTIFF out.

A satellite tile on disk in, its 2x product (and optionally a per-pixel
posterior-std map) out, radiometry preserved:

    # local model, on the CUDA card (--backend cpu: the plain CPU path)
    python -m simple_vae_rs_tpu_torch.raster scene_lr.tif scene_sr.tif \
        --model_ckpt ckpt/job [--int8 | --int8_weights]

    # against a running model server (no local model)
    python -m simple_vae_rs_tpu_torch.raster scene_lr.tif scene_sr.tif \
        --url http://127.0.0.1:8471 --uncertainty

Behavior, flags and defaults are the JAX package's ``raster`` command's:

- Reads any TIFF ``data/tiffio.read_tiff`` reads (striped, uint8/16/32,
  int16/32, float32, interleaved or band-sequential, LZW/deflate with the
  predictor). The output mirrors the input's band layout.
- The model takes min-max-normalized [0, 1] input and emits [0, 1]; by
  default the product is mapped back through the inverse of that
  normalization (``x * (max - min + 1e-5) + min`` per channel) and cast to
  the input dtype. ``--scale unit`` writes the raw [0, 1] float32.
- ``--uncertainty`` also writes the per-pixel posterior std (float32, in
  input units under ``--scale input``) beside the output (or at
  ``--std_out``), and the main output becomes the posterior mean over
  ``--samples`` draws.
- ``--stream`` sweeps the scene in bounded memory (two passes, strip
  windows in and out); ``--resume`` continues an interrupted sweep from
  its journal, bit-equal under ``--request_seed``; ``--url`` posts window
  batches to a model server (``client.RemoteResolver``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Tuple

import numpy as np

from simple_vae_rs_tpu_torch.data.tiffio import read_tiff, write_tiff

_EPS = 1e-5  # utils.image.normalize_image's, and tiling._tile_windows's


def _to_hwc(arr: np.ndarray, channels: Optional[int]) -> Tuple[np.ndarray, str]:
    """Raster as (H, W, C) plus the layout tag needed to write it back.

    ``read_tiff`` returns (H, W) single-band, (H, W, C) interleaved or
    (C, H, W) band-sequential; a bare 3-D array does not carry which.
    The expected channel count (from the model config or the server's
    /healthz) disambiguates; otherwise the small-axis heuristic does.
    """
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


def _from_hwc(arr: np.ndarray, layout: str) -> np.ndarray:
    if layout == "hw":
        return arr[:, :, 0]
    if layout == "chw":
        return np.moveaxis(arr, -1, 0)
    return arr


def _cast_like(arr: np.ndarray, dtype: np.dtype) -> np.ndarray:
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        return np.clip(np.rint(arr), info.min, info.max).astype(dtype)
    return arr.astype(dtype)


def _open_endpoints(args):
    """(sr_tile, unc_tile, expected_channels) for local or remote mode."""
    if args.url:
        from simple_vae_rs_tpu_torch.client import Client

        wire = getattr(args, "wire", "f32")
        c = Client(args.url, timeout=args.timeout, token=args.token,
                   wire=wire)
        info = c.health()
        if wire == "u16" and not info.get("wire_u16"):
            raise SystemExit(
                "--wire u16: this server predates the u16 wire (/healthz "
                "has no 'wire_u16' capability) — drop the flag against it"
            )
        if getattr(args, "request_seed", None) is not None \
                and not info.get("seed"):
            # same guard RemoteResolver._check_seed applies on the
            # streaming path: a pre-seed server ignores unknown query
            # params, silently breaking the bit-identical-product promise
            raise SystemExit(
                "--request_seed: this server predates per-request seeds "
                "(/healthz has no 'seed' capability) — it would silently "
                "ignore the param"
            )
        return c.super_resolve_tile, c.uncertainty_tile, info.get("channels")
    if not args.model_ckpt:
        raise SystemExit("one of --model_ckpt or --url is required")
    r = _local_resolver(args)
    return r.super_resolve_tile, r.uncertainty_tile, int(r.model.config.channels)


def _local_resolver(args):
    """The local model of ``--model_ckpt`` on ``--backend``'s device."""
    from simple_vae_rs_tpu_torch.serve import SuperResolver, backend_device

    return SuperResolver.from_checkpoint(
        args.model_ckpt, cr=args.compression_ratio,
        patch_size=args.patch_size, channels=args.channels,
        latent_size=args.latent_size, model_type=args.model_type,
        seed=args.seed, int8=args.int8,
        int8_weights=getattr(args, "int8_weights", False),
        device=backend_device(getattr(args, "backend", "")),
    )


def _stream_stats(reader, to_hwc, block_rows: int):
    """Pass 1 of the streaming sweep: per-channel finite min/max + bad count."""
    import warnings

    mn = mx = None
    bad = 0
    for r0 in range(0, reader.height, block_rows):
        r1 = min(reader.height, r0 + block_rows)
        blk = to_hwc(reader.read_rows(r0, r1)).astype(np.float32)
        finite = np.isfinite(blk)
        bad += int(blk.size - finite.sum())
        safe = np.where(finite, blk, np.nan)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)  # all-NaN blocks
            bmn = np.nanmin(safe, axis=(0, 1))
            bmx = np.nanmax(safe, axis=(0, 1))
        mn = bmn if mn is None else np.fmin(mn, bmn)
        mx = bmx if mx is None else np.fmax(mx, bmx)
    mn = np.where(np.isfinite(mn), mn, 0.0).astype(np.float32)
    mx = np.where(np.isfinite(mx), mx, 0.0).astype(np.float32)
    return mn, mx, bad


def run_stream(args) -> None:
    """Bounded-memory whole-scene SR: two strip-windowed passes.

    Pass 1 sweeps the input once for the per-channel finite min/max (the
    global normalization the in-memory path computes on the materialized
    raster); pass 2 streams window-row bands through the resolver's
    ``iter_tile_rows`` and appends finalized SR rows to a
    ``TiffStripWriter``. Peak memory is O(width), independent of the
    scene height — a whole scene never materializes. With
    ``--url`` the window batches post to the model server
    (``client.RemoteResolver``), so neither side materializes the scene.
    """
    from simple_vae_rs_tpu_torch.data.tiffio import TiffReader, TiffStripWriter

    if args.url:
        from simple_vae_rs_tpu_torch.client import Client, ServerError

        try:
            resolver = Client(args.url, timeout=args.timeout,
                              token=args.token,
                              wire=getattr(args, "wire", "f32")).resolver()
        except ServerError as e:
            # capability guards (seed/wire vs an older server) and
            # unreachable hosts deserve the CLI's clean message, not a
            # traceback — same UX as the in-memory path's checks
            raise SystemExit(f"--url: {e}")
        expected = resolver.channels
    elif args.model_ckpt:
        resolver = _local_resolver(args)
        expected = int(resolver.model.config.channels)
    else:
        raise SystemExit("one of --model_ckpt or --url is required")
    p = resolver.window

    reader = TiffReader(args.input)
    if reader.height < p or reader.width < p:
        reader.close()
        print(f"raster smaller than one {p}px model window; "
              f"falling back to the in-memory path")
        return run(args)
    layout = reader.layout
    channels = 1 if layout == "hw" else reader.samples_per_pixel
    if expected is not None and channels != expected:
        raise SystemExit(
            f"{args.input}: {channels} band(s), model expects {expected}"
        )

    to_hwc = reader.to_hwc

    h, w = reader.height, reader.width
    in_dtype = reader.dtype
    out_dtype = in_dtype if args.scale == "input" else np.dtype(np.float32)
    predictor = (args.predictor and args.scale == "input"
                 and not np.issubdtype(in_dtype, np.floating))
    samples = args.samples or (32 if args.uncertainty else 1)
    ov = args.overlap if args.overlap is not None else min(4, p // 2)
    batch = args.batch or 16
    std_out = args.std_out
    if args.uncertainty and not std_out:
        stem, ext = os.path.splitext(args.output)
        std_out = f"{stem}_std{ext or '.tif'}"

    # --resume: a sidecar journal checkpoints the sweep after every
    # finalized band (writer state + next band index). Interrupt the run
    # anywhere and re-run with --resume: already-written bands are not
    # re-yielded (iter_tile_rows(start_band=...) itself recomputes just the
    # windows that still reach the resumed band), and because the request seed pins
    # every window draw, the resumed product is bitwise the product of an
    # uninterrupted run. The seed is REQUIRED: without it the seam band's
    # recomputed draws would differ from the rows already on disk.
    journal_path = args.output + ".resume.json"
    fingerprint = {
        "input": os.path.abspath(args.input),
        "input_size": os.path.getsize(args.input),
        "hw": [h, w], "channels": channels,
        "overlap": ov, "batch": batch, "samples": samples,
        "uncertainty": bool(args.uncertainty),
        "scale": args.scale, "compression": args.compression,
        "predictor": bool(predictor), "seed": args.request_seed,
        "dtype": str(np.dtype(out_dtype)), "std_out": std_out,
        # model identity: resuming with a different network would splice
        # two models' rows into one product — exactly what the
        # different-invocation guard exists to refuse
        "model": {
            "url": args.url or None,
            "ckpt": (os.path.abspath(args.model_ckpt)
                     if args.model_ckpt else None),
            "int8": bool(args.int8),
            "int8_weights": bool(getattr(args, "int8_weights", False)),
            "window": p,
            "model_type": args.model_type,
            "cr": args.compression_ratio,
            "latent_size": args.latent_size,
        },
    }
    journal = None
    if args.resume:
        if args.request_seed is None:
            raise SystemExit(
                "--resume requires --request_seed: only a pinned request "
                "seed makes the recomputed seam band's draws identical to "
                "the rows already on disk"
            )
        if os.path.exists(journal_path):
            with open(journal_path) as fh:
                journal = json.load(fh)
            if journal.get("fingerprint") != fingerprint:
                raise SystemExit(
                    f"{journal_path} was written by a different invocation "
                    f"(input or options changed) — delete it to start over"
                )
            print(f"resuming at band {journal['next_band']} "
                  f"(from {journal_path})")
        else:
            print("no resume journal found; starting a fresh sweep")
    elif os.path.exists(journal_path):
        os.remove(journal_path)  # fresh non-resume run truncates the output

    if journal is not None:
        mn = np.asarray(journal["norm"]["mn"], np.float32)
        mx = np.asarray(journal["norm"]["mx"], np.float32)
        bad = int(journal["norm"]["bad"])
    else:
        mn, mx, bad = _stream_stats(reader, to_hwc,
                                    max(reader.rows_per_strip, 256))
    if bad:
        print(f"warning: {bad} non-finite sample(s) in {args.input} "
              f"filled with the per-channel finite minimum")
    norm_record = {"mn": mn.tolist(), "mx": mx.tolist(), "bad": bad}
    mn = mn[None, None]
    denom = (mx[None, None] - mn) + _EPS

    def read_norm(r0, r1):
        blk = to_hwc(reader.read_rows(r0, r1)).astype(np.float32)
        nb = ~np.isfinite(blk)
        if nb.any():
            blk = np.where(nb, mn, blk)
        return (blk - mn) / denom

    next_band = int(journal["next_band"]) if journal else 0
    writer = TiffStripWriter(
        args.output, 2 * h, 2 * w, channels, out_dtype,
        planar_channels_first=layout == "chw",
        compression=args.compression, predictor=predictor,
        resume_state=journal["writer"] if journal else None,
    )
    std_writer = None
    if args.uncertainty:
        std_writer = TiffStripWriter(
            std_out, 2 * h, 2 * w, channels, np.float32,
            planar_channels_first=layout == "chw",
            compression=args.compression, predictor=False,
            resume_state=journal["std_writer"] if journal else None,
        )
    # one generator yield per window-row band; scene sweeps are long
    # (up to hours over remote links), so report progress on stderr —
    # every band on a tty (carriage-return style), ~5% steps otherwise
    from simple_vae_rs_tpu_torch.tiling import grid_starts

    n_bands = len(grid_starts(h, p, (p - ov) if ov else p))
    tty = sys.stderr.isatty()
    every = 1 if tty else max(1, n_bands // 20)
    start_band = next_band  # iter_tile_rows rebuilds the overlap itself

    # --stall_timeout: a hung device (or server) blocks a dispatch
    # forever and Python cannot interrupt it, so a stuck sweep would
    # otherwise hang until the scheduler kills it. The watchdog hard-exits (os._exit —
    # a blocked runtime thread would stall a clean shutdown) once no
    # band has completed within the budget; with --resume the journal
    # from the last completed band is already on disk, so the product
    # continues from where it stalled.
    import threading
    import time as _time

    stall = float(getattr(args, "stall_timeout", 0.0) or 0.0)
    # The watchdog arms only after the FIRST band completes: band 1
    # includes the first use of the kernels (their build) and, with
    # --url, the server's warm-up — killing it would livelock a --resume
    # retry into the same start.
    _beat = [None]
    _done = threading.Event()
    if stall > 0:
        def _watch() -> None:
            while not _done.wait(min(max(stall / 4.0, 0.5), 30.0)):
                if _beat[0] is not None and _time.monotonic() - _beat[0] > stall:
                    print(
                        f"no band completed in {stall:.0f}s — the device "
                        f"or the server stalled; aborting"
                        + (f" (re-run with --resume to continue from "
                           f"{journal_path})" if args.resume else
                           " (use --resume to make stalls recoverable)"),
                        file=sys.stderr,
                    )
                    os._exit(3)

        threading.Thread(target=_watch, daemon=True,
                         name="svrs-stall-watchdog").start()
    bands = () if start_band >= n_bands else resolver.iter_tile_rows(
        read_norm, h, w, overlap=args.overlap, batch=batch,
        samples=samples, moments=args.uncertainty,
        seed=args.request_seed, start_band=start_band,
    )  # a journal written after the final band leaves nothing to compute
    try:
        for i, (_base, block) in enumerate(bands):
            k = start_band + i
            _beat[0] = _time.monotonic()  # a band arrived: feed the watchdog
            if (k + 1) % every == 0 or k + 1 == n_bands:
                print(f"  band {k + 1}/{n_bands}", end="\r" if tty else "\n",
                      file=sys.stderr)
            sr = block["mean"] if args.uncertainty else block
            if args.scale == "input":
                out = _cast_like(sr * denom + mn, in_dtype)
            else:
                out = sr.astype(np.float32)
            writer.write_rows(_from_hwc(out, layout))
            if std_writer is not None:
                std = block["std"]
                if args.scale == "input":
                    std = std * denom  # std is scale-equivariant; no offset
                std_writer.write_rows(
                    _from_hwc(std.astype(np.float32), layout))
            if args.resume:
                state = {
                    "format": "svrs-stream-resume/2",
                    "fingerprint": fingerprint,
                    "next_band": k + 1,
                    "norm": norm_record,
                    "writer": writer.checkpoint(),
                    "std_writer": (std_writer.checkpoint()
                                   if std_writer else None),
                }
                tmp = journal_path + ".tmp"
                with open(tmp, "w") as fh:
                    json.dump(state, fh)
                os.replace(tmp, journal_path)  # atomic: old journal or new
    except BaseException as e:
        # a mid-sweep failure (ServerError, Ctrl-C, wedge abort) must not
        # leak the fds or emit a bogus IFD on the partial output — use the
        # writers' __exit__-on-error semantics (fd closed, IFD pointer
        # left zeroed; the journal makes the partial product resumable)
        _done.set()
        writer.__exit__(type(e), e, None)
        if std_writer is not None:
            std_writer.__exit__(type(e), e, None)
        reader.close()
        raise
    _done.set()
    if tty:
        print(file=sys.stderr)  # leave the \r progress line intact
    writer.close()
    if std_writer is not None:
        std_writer.close()  # before the journal removal: both IFDs or none
    reader.close()
    if args.resume and os.path.exists(journal_path):
        os.remove(journal_path)  # complete: the product stands alone
    print(f"wrote {args.output} (streamed): ({2 * h}, {2 * w}, {channels}) "
          f"{np.dtype(out_dtype)} "
          f"({'input-scale' if args.scale == 'input' else '[0,1] float'})")
    if std_writer is not None:
        print(f"wrote {std_out}: posterior std, float32")


def run(args) -> None:
    sr_tile, unc_tile, channels = _open_endpoints(args)
    raw = read_tiff(args.input)
    hwc, layout = _to_hwc(raw, channels)
    if channels is not None and hwc.shape[-1] != channels:
        raise SystemExit(
            f"{args.input}: {hwc.shape[-1]} band(s), model expects {channels}"
        )
    in_dtype = raw.dtype
    lr = hwc.astype(np.float32)
    bad = ~np.isfinite(lr)
    if bad.any():
        # nodata/NaN pixels (routine in real satellite tiles) would
        # poison the min-max normalize and the model; fill with the
        # per-channel finite minimum (the darkest valid value) and say so
        fill = np.nanmin(np.where(bad, np.nan, lr), axis=(0, 1))
        fill = np.where(np.isfinite(fill), fill, 0.0)
        lr = np.where(bad, fill[None, None], lr)
        print(f"warning: {int(bad.sum())} non-finite sample(s) in "
              f"{args.input} filled with the per-channel finite minimum")
    mn = lr.min(axis=(0, 1), keepdims=True)
    denom = lr.max(axis=(0, 1), keepdims=True) - mn + _EPS

    opts = dict(overlap=args.overlap, batch=args.batch,
                seed=args.request_seed)
    if args.uncertainty:
        maps = unc_tile(lr, samples=args.samples or 32, **opts)
        sr, std = np.asarray(maps["mean"]), np.asarray(maps["std"])
    else:
        sr = np.asarray(sr_tile(lr, samples=args.samples, **opts))
        std = None

    predictor = args.predictor and not np.issubdtype(in_dtype, np.floating)
    if args.scale == "input":
        out = _cast_like(sr * denom + mn, in_dtype)
    else:
        out = sr.astype(np.float32)
        predictor = False
    write_tiff(args.output, _from_hwc(out, layout),
               planar_channels_first=layout == "chw",
               compression=args.compression, predictor=predictor)
    print(f"wrote {args.output}: {out.shape} {out.dtype} "
          f"({'input-scale' if args.scale == 'input' else '[0,1] float'})")

    if std is not None:
        std_out = args.std_out
        if not std_out:
            stem, ext = os.path.splitext(args.output)
            std_out = f"{stem}_std{ext or '.tif'}"
        if args.scale == "input":
            std = std * denom  # std is scale-equivariant; no offset
        write_tiff(std_out, _from_hwc(std.astype(np.float32), layout),
                   planar_channels_first=layout == "chw",
                   compression=args.compression, predictor=False)
        print(f"wrote {std_out}: posterior std, float32")


def main(argv: Optional[list] = None) -> None:
    p = argparse.ArgumentParser(
        prog="python -m simple_vae_rs_tpu_torch.raster",
        description="2x super-resolve a whole GeoTIFF raster "
                    "(optionally with a posterior-uncertainty map).",
    )
    p.add_argument("input", help="LR raster (any size the codec reads)")
    p.add_argument("output", help="SR raster to write (2H x 2W)")
    src = p.add_argument_group("model source (one of)")
    src.add_argument("--model_ckpt", help="local checkpoint path")
    src.add_argument("--url", help="running model server, e.g. "
                     "http://127.0.0.1:8471 (ignores the local-model flags)")
    loc = p.add_argument_group(
        "local model config (defaults come from the config the trainer "
        "embedded in the checkpoint; flags override)")
    loc.add_argument("-cr", "--compression_ratio", type=float, default=None)
    loc.add_argument("--patch_size", type=int, default=None)
    loc.add_argument("--channels", type=int, default=None)
    loc.add_argument("--latent_size", type=int, default=None)
    loc.add_argument("--model_type", default=None,
                     choices=["Cond_SRVAE", "SRVAE"])
    loc.add_argument("--int8", action="store_true",
                     help="serve through the W8A8 decoder (int8 kernels, "
                     "activations quantized in the call)")
    loc.add_argument("--int8_weights", action="store_true",
                     help="weights-only int8: quantized at load, "
                     "dequantized per request")
    loc.add_argument("--seed", type=int, default=0,
                     help="local resolver RNG seed (rolling state; a fresh "
                     "local run is deterministic for a given seed)")
    p.add_argument("--request_seed", type=int, default=None,
                   help="per-request reproducibility seed: the product's "
                   "posterior draws derive purely from this value, so the "
                   "same input + seed + options yields a bit-identical "
                   "product locally, against any server replica "
                   "(--url; the server must advertise the 'seed' "
                   "capability), and on re-runs after interruption")
    p.add_argument("--uncertainty", action="store_true",
                   help="output = posterior mean; also write the std map")
    p.add_argument("--samples", type=int, default=None,
                   help="posterior draws per window (SR default 1; "
                   "uncertainty default 32)")
    p.add_argument("--overlap", type=int, default=None,
                   help="window overlap in LR pixels (default: auto)")
    p.add_argument("--batch", type=int, default=None,
                   help="windows per dispatch (default 16)")
    p.add_argument("--std_out", help="path for the std map "
                   "(default: <output>_std.<ext>)")
    p.add_argument("--scale", choices=["input", "unit"], default="input",
                   help="'input': map SR back to the input radiometry and "
                   "dtype (default); 'unit': raw [0,1] float32")
    p.add_argument("--compression", choices=["none", "deflate", "lzw"],
                   default="deflate", help="output compression (default "
                   "deflate; lzw encodes through the native C codec when "
                   "a compiler is available)")
    p.add_argument("--no_predictor", dest="predictor", action="store_false",
                   help="disable horizontal-differencing on integer output")
    p.add_argument("--stream", action="store_true",
                   help="bounded-memory two-pass sweep: read/SR/write the "
                   "scene in strip windows (peak memory O(width) instead "
                   "of O(scene); with --url, window batches post to the "
                   "server so neither side materializes the scene)")
    p.add_argument("--stall_timeout", type=float, default=0.0,
                   help="with --stream: hard-abort (exit 3) if no "
                   "window-row band completes within this many seconds — "
                   "a hung device blocks a dispatch forever and cannot be "
                   "interrupted from Python. Arms after the first band "
                   "(band 1 includes the kernels' first use). With "
                   "--resume the journal survives, so re-running "
                   "continues the product. 0 = off")
    p.add_argument("--resume", action="store_true",
                   help="with --stream: checkpoint the sweep to "
                   "<output>.resume.json after every band, and continue "
                   "an interrupted run from its journal instead of "
                   "starting over. Requires --request_seed (the pinned "
                   "draws make the resumed product bitwise identical to "
                   "an uninterrupted run).")
    p.add_argument("--backend", default="",
                   help="device of the local model: the CUDA card by "
                   "default, 'cpu' for the plain CPU path")
    p.add_argument("--wire", choices=["f32", "u16"], default="f32",
                   help="--url body encoding: 'u16' posts/fetches "
                   "quantized uint16 arrays (~2x fewer bytes; ~7.6e-6 "
                   "quantization error on [0,1] products). The server "
                   "must advertise 'wire_u16' in /healthz")
    p.add_argument("--timeout", type=float, default=600.0,
                   help="HTTP timeout for --url mode")
    p.add_argument("--token", default=os.environ.get("SVRS_TOKEN", ""),
                   help="bearer token for --url mode (default $SVRS_TOKEN)")
    args = p.parse_args(argv)
    if args.request_seed is not None and args.request_seed < 0:
        p.error("--request_seed must be a non-negative integer")
    if args.resume and not args.stream:
        p.error("--resume only applies to --stream runs")
    if args.wire == "u16" and not args.url:
        # the flag is a --url body encoding; local mode would silently
        # serve f32 products while the user believes they benchmarked u16
        p.error("--wire u16 only applies to --url mode (local products "
                "are always float32)")
    if args.stall_timeout and not args.stream:
        p.error("--stall_timeout only applies to --stream runs")
    if not args.url:
        from simple_vae_rs_tpu_torch.serve import backend_device

        backend_device(args.backend)  # an unknown --backend fails before any work
    # client endpoints reject batch=None-substitutes themselves; local
    # endpoints want concrete defaults
    if not args.url:
        args.batch = 16 if args.batch is None else args.batch
        if args.samples is None and not args.uncertainty:
            args.samples = 1
    if args.stream:
        run_stream(args)
    else:
        run(args)


if __name__ == "__main__":
    main()
