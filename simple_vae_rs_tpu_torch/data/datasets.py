"""Tile-pair datasets of the port (the JAX package's ``data/datasets.py``):
Sen2Venus, Floods and two synthetic generators.

Datasets are *tile sources*: ``__getitem__`` returns numpy HWC tile pairs
``(lr (H/2, W/2, C), hr (H, W, C))``. Integer tiles (Sen2Venus is int16
digital numbers) stay integer, so the host-to-device copy carries half the
bytes of float32; float tiles are float32. Cropping and normalization happen
on the device (``ops/patchify.py``), after the loader's copy.

- ``Sen2VenusDataset``: tab-separated ``index.csv`` with tile-pair paths in
  columns ``b2b3b4b8_10m`` (LR, 10 m Sentinel-2) and ``b2b3b4b8_05m`` (HR,
  5 m Venus), 4 bands (reference ``dataset.py:107-116``).
- ``FloodDataset``: directories of S2 tiffs; quantile-normalized patches
  (reference ``dataset.py:50-100``), as (patch, patch) pairs.
- ``SyntheticSRDataset``: smooth random fields with LR = the 2x2 box
  downsample of HR, so everything runs without the ARM tree.
- ``SyntheticHFDataset``: high-frequency scenes where super-resolution beats
  bicubic.
"""

from __future__ import annotations

import csv
import os
from typing import List, Tuple

import numpy as np

from simple_vae_rs_tpu_torch.data.tiffio import read_tiff


def _to_hwc(arr: np.ndarray) -> np.ndarray:
    """tifffile-style output -> (H, W, C), native dtype preserved.

    Integer tiles (Sen2Venus is int16 digital numbers) stay integer so the
    host-to-device copy carries half the bytes; the cast to float32 happens
    on the device before the crop (normalization is float32 regardless).
    """
    if arr.ndim == 2:
        arr = arr[..., None]
    elif arr.ndim == 3 and arr.shape[0] <= 16 and arr.shape[0] < arr.shape[-1]:
        arr = np.transpose(arr, (1, 2, 0))  # (C, H, W) -> (H, W, C)
    if arr.dtype.kind == "f" and arr.dtype != np.float32:
        arr = arr.astype(np.float32)
    return np.ascontiguousarray(arr)


class Sen2VenusDataset:
    """Sentinel-2 / Venus tile pairs listed by ``index.csv``."""

    def __init__(
        self,
        root: str = "ARM",
        bands: str = "visu",
        patch_size: int = 256,
    ) -> None:
        if bands != "visu":
            raise NotImplementedError("Only 'visu' bands are implemented.")
        self.root = os.path.abspath(root)
        self.patch_size = patch_size
        self.p0 = "b2b3b4b8_10m"  # LR (10 m)
        self.p1 = "b2b3b4b8_05m"  # HR (5 m)
        index = os.path.join(self.root, "index.csv")
        self.rows: List[Tuple[str, str]] = []
        with open(index, newline="") as fh:
            for rec in csv.DictReader(fh, delimiter="\t"):
                self.rows.append((rec[self.p0], rec[self.p1]))

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        lr_rel, hr_rel = self.rows[idx]
        lr = _to_hwc(read_tiff(os.path.join(self.root, lr_rel)))
        hr = _to_hwc(read_tiff(os.path.join(self.root, hr_rel)))
        return lr, hr


class FloodDataset:
    """Single-resolution flood patches; items are (patch, patch) pairs."""

    def __init__(self, root: str, patch_size: int = 64) -> None:
        self.patch_size = patch_size
        self.patches: List[np.ndarray] = []
        for site in sorted(os.listdir(root)):
            s2 = os.path.join(root, site, "S2")
            if not os.path.isdir(s2):
                continue
            for name in sorted(os.listdir(s2)):
                if not name.endswith(".tif"):
                    continue
                img = _to_hwc(read_tiff(os.path.join(s2, name)))
                self._extract_patches(img)

    def _extract_patches(self, img: np.ndarray) -> None:
        p = self.patch_size
        h, w = img.shape[:2]
        for row in range(0, h - p + 1, p):
            for col in range(0, w - p + 1, p):
                patch = img[row : row + p, col : col + p]
                qlo, qhi = np.quantile(patch, [0.01, 0.99], axis=(0, 1), keepdims=True)
                patch = np.clip((patch - qlo) / (qhi - qlo + 1e-5), 0.0, 1.0)
                if not np.isnan(patch).any():
                    self.patches.append(patch.astype(np.float32))

    def __len__(self) -> int:
        return len(self.patches)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        p = self.patches[idx]
        return p, p


class SyntheticSRDataset:
    """Deterministic synthetic LR/HR tile pairs (no files needed).

    HR tiles are smooth multi-band random fields; the LR tile is the 2x2
    box-downsample, so SR models have genuine structure to learn.
    """

    def __init__(
        self,
        length: int = 64,
        hr_size: int = 256,
        channels: int = 4,
        seed: int = 0,
    ) -> None:
        self.length = length
        self.hr_size = hr_size
        self.channels = channels
        self.seed = seed

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        if not 0 <= idx < self.length:
            raise IndexError(idx)
        rng = np.random.default_rng(self.seed * 1_000_003 + idx)
        hs = self.hr_size
        base = rng.standard_normal((hs // 16, hs // 16, self.channels))
        hr = np.kron(base, np.ones((16, 16, 1)))
        # smooth out the block edges with a small separable box blur
        k = 8
        pad = np.pad(hr, ((k, k), (k, k), (0, 0)), mode="edge")
        cs = np.cumsum(pad, axis=0)
        hr = (cs[2 * k :] - cs[: -2 * k]) / (2 * k)
        cs = np.cumsum(hr, axis=1)
        hr = (cs[:, 2 * k :] - cs[:, : -2 * k]) / (2 * k)
        hr = hr[:hs, :hs]
        hr = hr + 0.05 * rng.standard_normal(hr.shape)
        lr = hr.reshape(hs // 2, 2, hs // 2, 2, self.channels).mean(axis=(1, 3))
        scale = 1000.0  # raw-ish digital numbers; normalization happens on device
        return (
            (lr * scale).astype(np.float32),
            (hr * scale).astype(np.float32),
        )


class SyntheticHFDataset:
    """High-frequency synthetic LR/HR pairs — the arm where SR must BEAT
    bicubic (the comparison the reference exists to win: its headline
    quality story is SR-vs-bicubic-2x SSIM/LPIPS,
    reference ``models/cond_vae.py:464-474``; on the smooth
    :class:`SyntheticSRDataset` fields bicubic wins, BASELINE.md).

    The design targets the decisive physics and avoids the failure mode
    measured on this family (BASELINE.md): a single-draw VAE cannot win
    SSIM on scenes with super-Nyquist ambiguity (sharp sub-pixel edges
    leave irreducible posterior spread, whose draw noise caps SSIM at
    ~0.45 regardless of training length), and it cannot win on smooth
    scenes either (bicubic is near-perfect there). What it CAN win is
    the regime real cross-sensor SR lives in:

    - **HR is (nearly) a deterministic function of LR.** The rendered
      geometry — band-correlated Voronoi cells, streaks, blobs, smooth
      illumination — is softened (``hr_soft_sigma``) so essentially all
      HR energy sits below the LR Nyquist: the posterior p(HR | LR) is
      tight, so single draws concentrate and the model's SSIM is not
      noise-capped.
    - **Strong mid-frequency texture** (band-correlated band-pass field,
      ``mid_amp``, wavelengths ~6-12 HR px): content that SURVIVES the
      2x decimation but is heavily attenuated by the cross-sensor PSF.
    - **The LR carries its own, coarser PSF** (``lr_psf_sigma``, default
      2.0 HR px — Sen2Venus 10 m vs 5 m bands are separate instruments,
      not an ideal decimation) plus sensor noise (``lr_noise``).

    Bicubic interpolation reproduces the PSF's attenuation — it cannot
    re-amplify the mid band, which costs it heavily in SSIM's contrast
    term and in PSNR. A learned restorer deconvolves it (the task is
    well-posed: everything is sub-Nyquist and the prior is strong).
    Measured on 64px tiles: bicubic SSIM falls to ~0.75 while a crude
    global Wiener filter already recovers ground on it — the margin a
    trained model must widen.
    """

    def __init__(
        self,
        length: int = 64,
        hr_size: int = 256,
        channels: int = 4,
        seed: int = 0,
        lr_psf_sigma: float = 2.0,
        lr_noise: float = 0.003,
        hr_soft_sigma: float = 1.2,
        mid_amp: float = 0.15,
    ) -> None:
        self.length = length
        self.hr_size = hr_size
        self.channels = channels
        self.seed = seed
        self.lr_psf_sigma = float(lr_psf_sigma)
        self.lr_noise = float(lr_noise)
        self.hr_soft_sigma = float(hr_soft_sigma)
        self.mid_amp = float(mid_amp)
        # tiles are pure functions of (seed, idx) but cost real work to
        # render (Voronoi + supersample); memoize per instance so epoch
        # re-iteration doesn't re-render (64 x 256px tiles ~= 84 MB)
        self._cache: dict = {}

    def __len__(self) -> int:
        return self.length

    def _render(self, rng: np.random.Generator, gs: int) -> np.ndarray:
        """Scene radiance on a ``gs``-pixel grid (the 2x supersample)."""
        C = self.channels
        hs = self.hr_size
        # material spectra: per-material brightness x per-band modulation
        # (strongly band-correlated, like real surface types)
        M = 6
        bright = 0.15 + 0.75 * rng.random((M, 1))
        spectra = np.clip(bright * (0.6 + 0.8 * rng.random((M, C))), 0.05, 1.2)
        # Voronoi cells at continuous coordinates, dense enough that step
        # edges dominate the error budget (the structure bicubic is worst
        # at: ~one cell per 20x20 HR px)
        K = max(10, (hs * hs) // 400)
        sites = rng.random((K, 2)) * gs
        mat = rng.integers(0, M, K)
        gain = 0.8 + 0.4 * rng.random(K)
        yy, xx = np.mgrid[0:gs, 0:gs]
        label = self._nearest_site(yy, xx, sites)
        img = (spectra[mat] * gain[:, None])[label]  # (gs, gs, C)
        # thin antialiased lines
        L = max(3, hs // 24)
        for _ in range(L):
            p0 = rng.random(2) * gs
            ang = rng.random() * np.pi
            n = np.array([np.sin(ang), -np.cos(ang)])  # unit normal
            d = np.abs((yy - p0[0]) * n[0] + (xx - p0[1]) * n[1])
            w = (0.6 + 0.8 * rng.random()) * (gs / hs)
            prof = np.exp(-((d / w) ** 2))
            spec = spectra[rng.integers(0, M)] * (0.8 + 0.4 * rng.random())
            a = prof[..., None]
            img = img * (1 - a) + spec * a
        # sub-pixel point sources
        P = max(10, (hs * hs) // 450)
        py, px = rng.random(P) * gs, rng.random(P) * gs
        sig = (0.5 + 0.3 * rng.random(P)) * (gs / hs)
        amp = 0.4 + 0.8 * rng.random(P)
        pm = rng.integers(0, M, P)
        for i in range(P):
            r = 3.0 * sig[i]
            y0, y1 = max(0, int(py[i] - r)), min(gs, int(py[i] + r) + 2)
            x0, x1 = max(0, int(px[i] - r)), min(gs, int(px[i] + r) + 2)
            if y0 >= y1 or x0 >= x1:
                continue
            dy = yy[y0:y1, x0:x1] - py[i]
            dx = xx[y0:y1, x0:x1] - px[i]
            g = amp[i] * np.exp(-(dy * dy + dx * dx) / (2 * sig[i] ** 2))
            img[y0:y1, x0:x1] += g[..., None] * spectra[pm[i]]
        # smooth multiplicative illumination (bilinear from a 4x4 grid)
        grid = 0.8 + 0.4 * rng.random((4, 4))
        t = np.linspace(0, 3, gs)
        i0 = np.clip(t.astype(int), 0, 2)
        f = t - i0
        rows = (grid[i0] * (1 - f[:, None]) + grid[i0 + 1] * f[:, None])
        illum = (rows[:, i0] * (1 - f[None, :]) + rows[:, i0 + 1] * f[None, :])
        return img * illum[..., None]

    @staticmethod
    def _psf(img: np.ndarray, sigma: float) -> np.ndarray:
        """Gaussian PSF over (H, W, C); scipy when present, separable
        numpy convolution otherwise (identical kernel, reflect edges)."""
        if sigma <= 0:
            return img
        try:
            from scipy.ndimage import gaussian_filter

            return gaussian_filter(img, (sigma, sigma, 0))
        except ImportError:
            r = max(1, int(np.ceil(3 * sigma)))
            t = np.arange(-r, r + 1)
            k = np.exp(-0.5 * (t / sigma) ** 2)
            k /= k.sum()
            pad = np.pad(img, ((r, r), (0, 0), (0, 0)), mode="reflect")
            img = sum(k[i] * pad[i : i + img.shape[0]] for i in range(2 * r + 1))
            pad = np.pad(img, ((0, 0), (r, r), (0, 0)), mode="reflect")
            return sum(
                k[i] * pad[:, i : i + img.shape[1]] for i in range(2 * r + 1)
            )

    @staticmethod
    def _nearest_site(yy, xx, sites) -> np.ndarray:
        """Per-pixel nearest-site label; KD-tree when scipy is present
        (O(N log K) — the difference between ~5 s and ~0.1 s per 256px
        tile), brute-force chunked argmin otherwise."""
        try:
            from scipy.spatial import cKDTree

            pts = np.stack([yy.ravel(), xx.ravel()], axis=1)
            _, idx = cKDTree(sites).query(pts)
            return idx.reshape(yy.shape)
        except ImportError:
            gs = yy.shape[0]
            label = np.empty(yy.shape, np.int32)
            for r0 in range(0, gs, 64):
                r1 = min(gs, r0 + 64)
                d2 = (
                    (yy[r0:r1, :, None] - sites[:, 0]) ** 2
                    + (xx[r0:r1, :, None] - sites[:, 1]) ** 2
                )
                label[r0:r1] = np.argmin(d2, axis=-1)
            return label

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        if not 0 <= idx < self.length:
            raise IndexError(idx)
        if idx in self._cache:
            return self._cache[idx]
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + idx) ^ 0x5F5F5F
        )
        hs = self.hr_size
        gs = hs * 2  # 2x supersample -> area-weighted HR edge pixels
        img = self._render(rng, gs)
        # soften the geometry below the LR Nyquist so p(HR | LR) is tight
        # (sub-pixel step edges would leave irreducible draw noise)
        img = self._psf(img, 2.0 * self.hr_soft_sigma)
        hr = img.reshape(hs, 2, hs, 2, self.channels).mean(axis=(1, 3))
        if self.mid_amp:
            # band-correlated mid-frequency texture: survives the 2x
            # decimation, crushed by the LR PSF — the band the learned
            # restorer wins back and bicubic cannot
            t = rng.standard_normal((hs, hs, 1)).astype(np.float32)
            mid = self._psf(t, 1.2) - self._psf(t, 3.0)
            mid /= mid.std() + 1e-9
            w = (0.7 + 0.6 * rng.random((1, 1, self.channels))).astype(
                np.float32
            )
            hr = hr + self.mid_amp * mid * w
            # radiance floor: texture tails must not undercut the dark
            # anchor (sensors don't see negative radiance either)
            hr = np.clip(hr, 0.05, None)
        # extrema anchors: one broad dark and one broad bright flat-top
        # disc per tile (extended surfaces — water/shadow, bright
        # sand/roofs — ARE where real scenes' extremes live). They pin
        # each channel's min/max to features large enough to survive the
        # PSF, which makes the per-image min-max normalization both
        # sides apply (the reference's semantics) PSF-STABLE: without
        # them the blurred LR's extrema drift ~30% of the range from the
        # HR's, scrambling the LR->HR affine per tile — a bias no model
        # can learn around (measured: the generation SSIM caps at ~0.35
        # however long training runs).
        ay, ax = np.mgrid[0:hs, 0:hs]
        hi = hr.max(axis=(0, 1), keepdims=True)
        for bright in (False, True):
            cy = (0.1 + 0.8 * rng.random()) * hs
            # opposite halves so one disc can never swallow the other
            cx = (0.05 + 0.4 * rng.random() + (0.5 if bright else 0.0)) * hs
            rad = max(8.0, hs / 6.0) * (1.0 + 0.3 * rng.random())
            d2 = ((ay - cy) ** 2 + (ax - cx) ** 2) / (rad * rad)
            # wide flat core (cubed-Gaussian falloff): the PSF must see
            # a plateau, not a peak, or the LR extremum drifts
            a = np.exp(-((d2 / 2.0) ** 3))[..., None]
            tgt = 1.12 * hi if bright else 0.0
            hr = hr * (1 - a) + a * tgt
        blurred = self._psf(hr, self.lr_psf_sigma)
        lr = blurred.reshape(
            hs // 2, 2, hs // 2, 2, self.channels
        ).mean(axis=(1, 3))
        if self.lr_noise:
            lr = lr + self.lr_noise * rng.standard_normal(lr.shape)
        scale = 1000.0  # raw-ish DNs; normalization happens on device
        pair = (
            (lr * scale).astype(np.float32),
            (hr * scale).astype(np.float32),
        )
        self._cache[idx] = pair
        return pair
