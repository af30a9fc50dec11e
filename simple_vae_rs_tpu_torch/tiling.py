"""Grid tiling and feathered stitching: serve a raster of any size.

The model works on fixed-size windows (one LR patch of ``patch_size // 2``
pixels). A raster is covered with an overlapping grid of such windows
(``grid_starts``: stride = window - overlap, the last window flush with the
edge), the windows go through the resolver in fixed-size batches, and the
2x outputs are blended back (``stitch``): separable feather weights, linear
ramps over the overlap band, normalized by the summed weight, so coverage
never changes brightness. If every window output is a crop of one image,
``stitch`` gives that image back exactly.

``TileEndpoints`` is the mixin that turns any resolver with a ``window``, a
``normalize`` flag and a batched ``super_resolve`` into whole-raster
endpoints: ``super_resolve_tile``, ``uncertainty_tile`` and the
bounded-memory row sweep ``iter_tile_rows``. The port's
``serve.SuperResolver`` (on the card) and the HTTP client's
``client.RemoteResolver`` both use it, so the windowing and the stitching
are the same on either side of the wire.

This module is numpy only: the client imports it without torch. Results a
resolver returns are brought to the host by ``to_host``, which copies a
tensor on any device to float32 numpy and takes numpy arrays and the
client's lazy results as they are.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def to_host(x) -> np.ndarray:
    """A resolver's result as float32 numpy: a torch tensor (on the card or
    the host) is copied to the host; anything else goes through
    ``np.asarray`` (numpy arrays, the client's ``_Deferred``)."""
    if hasattr(x, "detach") and hasattr(x, "cpu"):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def subseed(seed: int, *path: int) -> int:
    """Seed of dispatch ``path`` of a seeded request: a pure function of the
    request seed and the dispatch's position, independent of its siblings
    (``np.random.SeedSequence``, stable across numpy versions), so the seed
    an in-process resolver uses for window batch ``i`` is the one the remote
    client sends for it."""
    if seed < 0:
        raise ValueError(f"seed must be a non-negative integer (got {seed})")
    return int(np.random.SeedSequence(seed, spawn_key=path).generate_state(1)[0])


def grid_starts(size: int, patch: int, stride: int) -> List[int]:
    """Window starts covering ``[0, size)``: every ``stride`` from 0, plus
    one flush with the edge (``size - patch``) where the grid stops short."""
    if patch <= 0 or stride <= 0:
        raise ValueError(f"patch and stride must be positive (got {patch}, {stride})")
    if patch > size:
        raise ValueError(f"patch {patch} exceeds image extent {size}")
    starts = list(range(0, size - patch + 1, stride))
    if starts[-1] != size - patch:
        starts.append(size - patch)
    return starts


def feather_profile(patch: int, overlap: int) -> np.ndarray:
    """1-D blend weights: linear ramps over ``overlap`` pixels (strictly
    positive, symmetric), 1 inside."""
    if not 0 <= overlap <= patch // 2:
        raise ValueError(f"overlap must be in [0, patch//2] (got {overlap} for patch {patch})")
    w = np.ones(patch, np.float32)
    if overlap:
        ramp = np.arange(1, overlap + 1, dtype=np.float32) / (overlap + 1)
        w[:overlap] = ramp
        w[patch - overlap:] = ramp[::-1]
    return w


def stitch(
    patches: np.ndarray,
    starts: Sequence[Tuple[int, int]],
    out_hw: Tuple[int, int],
    overlap: int,
) -> np.ndarray:
    """Blend (N, p, p, C) window outputs into an (H, W, C) mosaic: the
    per-pixel mean weighted by the outer product of ``feather_profile``."""
    patches = np.asarray(patches, np.float32)
    if patches.ndim != 4 or patches.shape[1] != patches.shape[2]:
        raise ValueError(f"patches must be (N, p, p, C), got {patches.shape}")
    if len(starts) != patches.shape[0]:
        raise ValueError(f"{patches.shape[0]} patches but {len(starts)} starts")
    p = patches.shape[1]
    prof = feather_profile(p, overlap)
    w = (prof[:, None] * prof[None, :])[..., None]
    num = np.zeros((*out_hw, patches.shape[-1]), np.float32)
    den = np.zeros((*out_hw, 1), np.float32)
    for (sh, sw), patch in zip(starts, patches):
        if sh < 0 or sw < 0 or sh + p > out_hw[0] or sw + p > out_hw[1]:
            raise ValueError(f"window at {(sh, sw)} falls outside {out_hw}")
        num[sh:sh + p, sw:sw + p] += w * patch
        den[sh:sh + p, sw:sw + p] += w
    if np.any(den == 0.0):
        raise ValueError("window grid leaves uncovered pixels")
    return num / den


class TileEndpoints:
    """Whole-raster endpoints over any batched ``super_resolve``.

    Subclass contract: ``self.window`` (the LR window in pixels),
    ``self.normalize`` (whether raster inputs get the global min-max
    normalization) and ``self.super_resolve(batch, normalize=..., seed=...)``
    mapping a ``(B, window, window, C)`` LR batch to ``(B, 2 window,
    2 window, C)``. An optional ``super_resolve_moments(wins, samples,
    seed=...)`` returns the per-pixel sum and sum of squares over
    ``samples`` draws; optional ``*_async`` variants return lazy results.
    """

    # window batches kept in flight before the oldest is fetched: CUDA
    # launches are asynchronous, so the card decodes batch k while the host
    # launches batch k+1 and copies batch k-1 back; bounded so a large
    # raster's outputs never pile up in device memory
    _TILE_PIPELINE = 4

    def _dispatch_fn(self):
        """The batched dispatch of the pipelined loops: the async variant
        where the resolver has one, else ``super_resolve``."""
        fn = getattr(self, "super_resolve_async", None)
        return fn if callable(fn) else self.super_resolve

    def _moments_hook(self):
        """The moments hook, if any: ``super_resolve_moments`` is the switch
        (an instance attribute of ``None`` masks it); its async variant
        dispatches where there is one."""
        hook = getattr(self, "super_resolve_moments", None)
        if not callable(hook):
            return None
        fn = getattr(self, "super_resolve_moments_async", None)
        return fn if callable(fn) else hook

    def super_resolve_tile(
        self, y, overlap: Optional[int] = None, batch: int = 16,
        samples: int = 1, seed: Optional[int] = None,
    ) -> np.ndarray:
        """LR raster (H, W, C) of any size -> seam-free SR (2H, 2W, C).

        One normalization over the whole raster, an overlapping window grid
        (``overlap=None``: min(4, window // 2)), fixed-size batches (the
        last one padded by repeating its last window), and a feathered
        blend of the outputs at twice the overlap. A raster smaller than a
        window is reflect-padded up and cropped after. ``samples > 1``
        averages that many draws a window. ``seed`` pins dispatch ``j``'s
        noise to ``subseed(seed, j)``, so the same raster, seed and options
        give the same product.
        """
        if samples < 1:
            raise ValueError(f"samples must be >= 1 (got {samples})")
        wins, starts, (h, w), (hp, wp), overlap = self._tile_windows(y, overlap)
        if samples == 1:
            sr_wins = self._tile_pass(wins, batch, seed=seed)
        else:
            sr_wins, _ = self._tile_draw_moments(wins, samples, batch, seed=seed)
        out = stitch(sr_wins, [(2 * a, 2 * b) for a, b in starts], (2 * hp, 2 * wp), 2 * overlap)
        return out[:2 * h, :2 * w]

    def uncertainty_tile(
        self, y, samples: int = 32, overlap: Optional[int] = None,
        batch: int = 16, seed: Optional[int] = None,
    ) -> Dict[str, np.ndarray]:
        """Whole-raster posterior statistics: mean, std and variance maps.

        Per-window first and second moments over ``samples`` draws, each
        feather-stitched; the variance ``blend(E[x^2]) - blend(E[x])^2`` is
        the blended mixture's (never negative). ``seed`` as in
        ``super_resolve_tile``.
        """
        if samples < 2:
            raise ValueError(f"samples must be >= 2 (got {samples})")
        wins, starts, (h, w), (hp, wp), overlap = self._tile_windows(y, overlap)
        m1, m2 = self._tile_draw_moments(wins, samples, batch, seed=seed)
        starts_sr = [(2 * a, 2 * b) for a, b in starts]
        out_hw = (2 * hp, 2 * wp)
        mean = stitch(m1, starts_sr, out_hw, 2 * overlap)[:2 * h, :2 * w]
        e2 = stitch(m2, starts_sr, out_hw, 2 * overlap)[:2 * h, :2 * w]
        var = np.maximum(e2 - mean * mean, 0.0)
        return {"mean": mean, "std": np.sqrt(var), "variance": var}

    def iter_tile_rows(
        self,
        read_rows,
        height: int,
        width: int,
        overlap: Optional[int] = None,
        batch: int = 16,
        samples: int = 1,
        moments: bool = False,
        seed: Optional[int] = None,
        start_band: int = 0,
    ):
        """The streamed form of the ``*_tile`` endpoints: a generator of
        finished SR row bands over a raster of any height, in memory of one
        window row of input and about one SR window height of accumulation.

        ``read_rows(r0, r1)`` returns LR rows ``[r0, r1)`` as ``(rows,
        width, C)`` float32, already normalized (the caller owns the global
        min-max pass). Yields ``(sr_row0, block)`` in order: ``block`` is
        ``(rows, 2 width, C)`` float32, or with ``moments=True`` a dict of
        ``mean`` / ``std`` / ``variance`` blocks. The grid, weights and
        blend are the in-memory endpoints'. ``seed`` pins window row ``k``'s
        dispatches under ``subseed(seed, k)``.

        ``start_band`` resumes a partial sweep: the first yield is band
        ``start_band`` (seeds and ``sr_row0`` keep their full-sweep values).
        The overlap accumulator is rebuilt from the earliest window row that
        reaches into the resumed band (the flush-tail window may sit closer
        than the stride, so more than one row back can reach in); with a
        ``seed`` the resumed sweep gives the uninterrupted product bit for
        bit. A raster smaller than one window either way is not streamable.
        """
        p = int(self.window)
        if height < p or width < p:
            raise ValueError(
                f"raster {height}x{width} is smaller than one {p}px model "
                f"window; use super_resolve_tile/uncertainty_tile"
            )
        if overlap is None:
            overlap = min(4, p // 2)
        if not 0 <= overlap <= p // 2:
            raise ValueError(f"overlap must be in [0, {p // 2}] (got {overlap})")
        if samples < (2 if moments else 1):
            raise ValueError(f"samples must be >= {2 if moments else 1} (got {samples})")
        stride = p - overlap if overlap else p
        row_starts = grid_starts(height, p, stride)
        col_starts = grid_starts(width, p, stride)
        ps = 2 * p
        prof = feather_profile(ps, 2 * overlap)
        w2d = (prof[:, None] * prof[None, :])[..., None]

        if not 0 <= start_band < len(row_starts):
            raise ValueError(f"start_band {start_band} outside [0, {len(row_starts)})")
        # window j covers SR rows [2 rs_j, 2 rs_j + 2p): it reaches into the
        # resumed band iff rs_j + p > rs_start
        first_win = start_band
        while first_win > 0 and row_starts[first_win - 1] + p > row_starts[start_band]:
            first_win -= 1
        base = 2 * row_starts[first_win]  # first SR row accumulated
        num1 = num2 = den = None  # accumulators over SR rows [base, ...)

        def grown(buf, rows, chans):
            if buf is None:
                return np.zeros((rows, 2 * width, chans), np.float32)
            if rows > buf.shape[0]:
                pad = np.zeros((rows - buf.shape[0], 2 * width, buf.shape[2]), np.float32)
                return np.concatenate([buf, pad])
            return buf

        for k in range(first_win, len(row_starts)):
            rs = row_starts[k]
            lr = np.asarray(read_rows(rs, rs + p), np.float32)
            if lr.ndim != 3 or lr.shape[:2] != (p, width):
                raise ValueError(
                    f"read_rows({rs}, {rs + p}) returned shape {lr.shape}, "
                    f"expected ({p}, {width}, C)"
                )
            wins = np.stack([lr[:, cs:cs + p] for cs in col_starts])
            row_seed = subseed(seed, k) if seed is not None else None
            if moments or samples > 1:
                m1, m2 = self._tile_draw_moments(wins, samples, batch, seed=row_seed)
            else:
                m1, m2 = self._tile_pass(wins, batch, seed=row_seed), None
            top = 2 * rs + ps
            chans = m1.shape[-1]
            num1 = grown(num1, top - base, chans)
            den = grown(den, top - base, 1)
            if moments:
                num2 = grown(num2, top - base, chans)
            r_off = 2 * rs - base
            for j, cs in enumerate(col_starts):
                sl = (slice(r_off, r_off + ps), slice(2 * cs, 2 * cs + ps))
                num1[sl] += w2d * m1[j]
                den[sl] += w2d
                if moments:
                    num2[sl] += w2d * m2[j]
            flush_to = 2 * row_starts[k + 1] if k + 1 < len(row_starts) else 2 * height
            n = flush_to - base
            if n <= 0:
                continue
            if k < start_band:
                # recomputed only to rebuild the overlap: drop, do not yield
                num1, den, base = num1[n:], den[n:], flush_to
                if moments:
                    num2 = num2[n:]
                continue
            mean = num1[:n] / den[:n]
            if moments:
                e2 = num2[:n] / den[:n]
                var = np.maximum(e2 - mean * mean, 0.0)
                yield base, {"mean": mean, "std": np.sqrt(var), "variance": var}
                num2 = num2[n:]
            else:
                yield base, mean
            num1, den, base = num1[n:], den[n:], flush_to

    # ------------------------------------------------------ tile plumbing
    def _tile_windows(self, y, overlap: Optional[int]):
        """Normalize a raster once and cover it with the window grid: (N, p,
        p, C) windows, their starts, the raster's and the padded HW, and the
        overlap. Host numpy: the raster reaches the device only as windows."""
        y = np.asarray(y, np.float32)
        if y.ndim == 4:
            if y.shape[0] != 1:
                raise ValueError("tile endpoints serve one raster per call")
            y = y[0]
        if y.ndim != 3:
            raise ValueError(f"expected (H, W, C) raster, got shape {y.shape}")
        p = int(self.window)
        if overlap is None:
            overlap = min(4, p // 2)
        if not 0 <= overlap <= p // 2:
            raise ValueError(f"overlap must be in [0, {p // 2}] (got {overlap})")
        if self.normalize:
            # utils.image.normalize_image's formula, on the host
            mn = y.min(axis=(0, 1), keepdims=True)
            mx = y.max(axis=(0, 1), keepdims=True)
            y = (y - mn) / (mx - mn + 1e-5)
        h, w = y.shape[:2]
        pad_h, pad_w = max(0, p - h), max(0, p - w)
        if pad_h or pad_w:
            y = np.pad(y, ((0, pad_h), (0, pad_w), (0, 0)), mode="reflect")
        hp, wp = y.shape[:2]
        stride = p - overlap if overlap else p
        starts = [(sh, sw) for sh in grid_starts(hp, p, stride) for sw in grid_starts(wp, p, stride)]
        wins = np.stack([y[a:a + p, b:b + p] for a, b in starts])
        return wins, starts, (h, w), (hp, wp), overlap

    def _tile_pass(self, wins: np.ndarray, batch: int, seed: Optional[int] = None) -> np.ndarray:
        """One draw for every window, in fixed-size batches (the last padded)
        kept ``_TILE_PIPELINE`` deep; ``seed`` pins dispatch ``j`` to
        ``subseed(seed, j)`` (forwarded only when set)."""
        if batch < 1:
            raise ValueError(f"batch must be >= 1 (got {batch})")
        dispatch = self._dispatch_fn()
        pending: deque = deque()
        outs = []

        def fetch():
            # the padding is sliced off on the device, before the copy
            sr, short = pending.popleft()
            outs.append(to_host(sr[:sr.shape[0] - short] if short else sr))

        for j, i in enumerate(range(0, len(wins), batch)):
            chunk = wins[i:i + batch]
            short = batch - len(chunk)
            if short:
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], short, axis=0)])
            kw = {} if seed is None else {"seed": subseed(seed, j)}
            pending.append((dispatch(chunk, normalize=False, **kw), short))
            if len(pending) >= self._TILE_PIPELINE:
                fetch()
        while pending:
            fetch()
        return np.concatenate(outs)

    def _tile_draw_moments(
        self, wins: np.ndarray, samples: int, batch: int, seed: Optional[int] = None,
    ) -> tuple:
        """Per-window first and second per-pixel moments over ``samples``
        draws.

        With a moments hook each window batch is one dispatch returning the
        two sums. Without one every draw comes back: the (window, draw) list
        is window-major and packs into fixed-size batches
        (ceil(N samples / batch) dispatches); slots past the end repeat the
        last window and are dropped from the sums."""
        if batch < 1:
            raise ValueError(f"batch must be >= 1 (got {batch})")
        hook = self._moments_hook()
        if hook is not None:
            n = len(wins)
            s1 = s2 = None
            pending: deque = deque()

            def fetch_moments():
                nonlocal s1, s2
                (m1, m2), i0, valid = pending.popleft()
                m1, m2 = to_host(m1[:valid]), to_host(m2[:valid])
                if s1 is None:
                    s1 = np.zeros((n, *m1.shape[1:]), np.float32)
                    s2 = np.zeros_like(s1)
                s1[i0:i0 + valid] = m1
                s2[i0:i0 + valid] = m2

            for j, i in enumerate(range(0, n, batch)):
                chunk = wins[i:i + batch]
                valid = len(chunk)
                if valid < batch:
                    chunk = np.concatenate([chunk, np.repeat(chunk[-1:], batch - valid, axis=0)])
                kw = {} if seed is None else {"seed": subseed(seed, j)}
                pending.append((hook(chunk, samples, **kw), i, valid))
                if len(pending) >= self._TILE_PIPELINE:
                    fetch_moments()
            while pending:
                fetch_moments()
            return s1 / samples, s2 / samples

        n = len(wins)
        total = n * samples
        dispatch = self._dispatch_fn()
        s1 = s2 = None
        pending = deque()

        def fetch():
            nonlocal s1, s2
            sr_dev, idx, valid = pending.popleft()
            if valid < sr_dev.shape[0]:
                sr_dev = sr_dev[:valid]
            sr = to_host(sr_dev)
            if s1 is None:
                s1 = np.zeros((n, *sr.shape[1:]), np.float32)
                s2 = np.zeros_like(s1)
            np.add.at(s1, idx[:valid], sr)
            np.add.at(s2, idx[:valid], sr ** 2)

        for j, i in enumerate(range(0, total, batch)):
            idx = np.minimum(np.arange(i, i + batch) // samples, n - 1)
            kw = {} if seed is None else {"seed": subseed(seed, j)}
            pending.append((dispatch(wins[idx], normalize=False, **kw), idx,
                            min(batch, total - i)))
            if len(pending) >= self._TILE_PIPELINE:
                fetch()
        while pending:
            fetch()
        return s1 / samples, s2 / samples
