"""HTTP client of the model server: typed endpoints over binary bodies.

    from simple_vae_rs_tpu_torch.client import Client

    c = Client("http://127.0.0.1:8471")
    c.health()                                  # dict
    sr = c.super_resolve(lr_batch)              # (B, ps, ps, C) ndarray
    big = c.super_resolve_tile(lr_raster)       # (2H, 2W, C) ndarray
    maps = c.uncertainty(lr_patch, samples=64)  # {mean, std, variance}
    maps = c.uncertainty_tile(lr_raster)        # same, any raster size
    rr = c.resolver()                           # windowing on this side

Request bodies are ``.npy`` (``application/x-npy``); endpoint options
(``samples``/``chunk``/``overlap``/``batch``/``seed``) ride the query
string, so the body stays binary when options are set. ``Client(url,
wire="u16")`` switches both directions to the u16 quantized wire
(``wire.py``): half the bytes, half a channel-range step of error. It
needs a server that advertises ``wire_u16`` in ``/healthz``.

Standard library and numpy only: this module imports no torch, so it runs
where the compute stack is not installed. The protocol is the JAX
package's, so this client drives either package's server.
"""

from __future__ import annotations

import io
import json
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Dict, Optional

import numpy as np

from simple_vae_rs_tpu_torch.tiling import TileEndpoints

_JSON = "application/json"
_NPY = "application/x-npy"
_NPZ = "application/x-npz"


class ServerError(RuntimeError):
    """Non-2xx reply from the model server (message from its error body)."""


class Client:
    """Thin typed wrapper over the model server's HTTP endpoints.

    ``retries`` bounded exponential-backoff retries cover transient
    failures — connection resets, timeouts, 5xx — which matters most for
    the streaming tile sweeps: a whole-scene sweep is tens of thousands
    of requests over possibly-flaky links, and every endpoint here is
    stateless on the server (a retried draw just consumes another RNG
    fold), so retrying is always safe. 4xx replies are the caller's bug
    and never retried.
    """

    def __init__(self, base_url: str, timeout: float = 600.0,
                 retries: int = 2, backoff: float = 1.0,
                 token: str = "", wire: str = "f32") -> None:
        from simple_vae_rs_tpu_torch import wire as wire_mod

        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self.retries = max(0, int(retries))
        self.backoff = backoff
        self.token = token  # bearer token for servers started with --token
        if wire not in wire_mod.WIRE_VALUES:
            raise ValueError(
                f"unknown wire={wire!r} (use one of {wire_mod.WIRE_VALUES[1:]})")
        # "u16": quantized bodies both ways (see module docstring)
        self.wire = wire_mod.WIRE_U16 if wire == wire_mod.WIRE_U16 else "f32"

    # ------------------------------------------------------------- plumbing
    def _request(self, path: str, body: Optional[bytes] = None,
                 ctype: str = _JSON, degraded_ok: bool = False):
        import http.client
        import time

        headers = {} if body is None else {"Content-Type": ctype}
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        req = urllib.request.Request(
            self.base_url + path,
            data=body,
            method="GET" if body is None else "POST",
            headers=headers,
        )
        for attempt in range(self.retries + 1):
            if attempt:
                time.sleep(self.backoff * (2 ** (attempt - 1)))
            try:
                with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                    return resp.read(), resp.headers.get("Content-Type", _JSON)
            except urllib.error.HTTPError as e:
                raw = e.read()
                if degraded_ok and e.code == 503:
                    # /healthz answers 503 with the normal JSON payload when
                    # the device prober reports a wedged link — callers doing
                    # capability discovery still want the body
                    try:
                        json.loads(raw)
                        return raw, e.headers.get("Content-Type", _JSON)
                    except ValueError:
                        pass
                detail = raw.decode("utf-8", "replace")
                try:
                    detail = json.loads(detail).get("error", detail)
                except ValueError:
                    pass
                if e.code >= 500 and attempt < self.retries:
                    continue  # server-side hiccup: retry
                raise ServerError(f"{e.code} on {path}: {detail}") from None
            except (urllib.error.URLError, TimeoutError, ConnectionError,
                    http.client.HTTPException) as e:
                if attempt < self.retries:
                    continue  # transport hiccup: retry
                raise ServerError(
                    f"{path} failed after {attempt + 1} attempt(s): {e}"
                ) from None

    @staticmethod
    def _npy(arr) -> bytes:
        buf = io.BytesIO()
        np.save(buf, np.asarray(arr, np.float32))
        return buf.getvalue()

    def _body(self, arr) -> tuple:
        """(bytes, content-type) for a request array on this wire."""
        if self.wire == "u16":
            from simple_vae_rs_tpu_torch import wire

            buf = io.BytesIO()
            np.savez(buf, **wire.encode_arrays_u16(
                {"lr": np.asarray(arr, np.float32)}))
            return buf.getvalue(), _NPZ
        return self._npy(arr), _NPY

    @staticmethod
    def _decode(body: bytes, ctype: str) -> Dict[str, np.ndarray]:
        if ctype.startswith(_NPY):
            return {"sr": np.load(io.BytesIO(body), allow_pickle=False)}
        if ctype.startswith(_NPZ):
            from simple_vae_rs_tpu_torch import wire

            with np.load(io.BytesIO(body), allow_pickle=False) as z:
                # u16-wire replies carry <key>__lo/__hi companions;
                # decode_arrays dequantizes those and passes plain-f32
                # npz entries through, so one decoder serves both wires
                return wire.decode_arrays({k: z[k] for k in z.files})
        return {k: np.asarray(v) for k, v in json.loads(body).items()}

    def _post_array(self, path: str, lr, **options) -> Dict[str, np.ndarray]:
        """Always a binary body; options ride the query string.

        (An earlier revision fell back to a JSON ``tolist()`` body whenever
        an option was set — ~4x the bytes plus a float text round trip,
        exactly on the whole-raster endpoints where payloads are largest.
        The server merges query params under JSON body fields, so both
        encodings keep working for hand-rolled callers.) On the u16 wire
        the body is the quantized npz and ``wire=u16`` rides the query
        string so the response comes back quantized too."""
        opts = {k: v for k, v in options.items() if v is not None}
        if self.wire == "u16":
            opts["wire"] = "u16"
        if opts:
            path = f"{path}?{urllib.parse.urlencode(opts)}"
        body, body_type = self._body(lr)
        out, ctype = self._request(path, body, body_type)
        return self._decode(out, ctype)

    # ------------------------------------------------------------ endpoints
    def health(self) -> Dict[str, Any]:
        out, _ = self._request("/healthz", degraded_ok=True)
        return json.loads(out)

    def super_resolve(self, lr, normalize: Optional[bool] = None,
                      seed: Optional[int] = None) -> np.ndarray:
        """LR batch (B, ps/2, ps/2, C) -> single-draw SR (B, ps, ps, C).

        ``normalize`` overrides the server resolver's default for this
        request (``False`` for pre-normalized windows — the remote tile
        sweeps below send those). ``seed`` pins the request's posterior
        draw server-side: same input + seed + options -> bitwise-identical
        response (servers advertise support via ``/healthz``'s ``seed``
        field — older servers silently ignore the param, which
        ``RemoteResolver`` guards against)."""
        return self._post_array(
            "/v1/super_resolve", lr,
            normalize=None if normalize is None else int(bool(normalize)),
            seed=seed,
        )["sr"]

    def super_resolve_moments(
        self, lr, samples: int, normalize: bool = False,
        seed: Optional[int] = None,
    ) -> tuple:
        """LR window batch (B, ps/2, ps/2, C) -> device-reduced draw
        moments ``(s1, s2)`` of shape (B, ps, ps, C): per-pixel sum and
        sum-of-squares over ``samples`` posterior draws. One request
        returns a whole batch's statistics as two maps — the remote
        streaming-UQ fast path (servers advertise support via the
        ``moments`` field of ``/healthz``; see ``RemoteResolver``)."""
        out = self._post_array(
            "/v1/super_resolve_moments", lr,
            samples=int(samples), normalize=int(bool(normalize)),
            seed=seed,
        )
        return out["s1"], out["s2"]

    def super_resolve_tile(
        self, lr, overlap: Optional[int] = None, batch: Optional[int] = None,
        samples: Optional[int] = None, seed: Optional[int] = None,
    ) -> np.ndarray:
        """Arbitrary-size LR raster (H, W, C) -> stitched SR (2H, 2W, C)."""
        return self._post_array(
            "/v1/super_resolve_tile", lr,
            overlap=overlap, batch=batch, samples=samples, seed=seed,
        )["sr"]

    def uncertainty(
        self, lr, samples: Optional[int] = None, chunk: Optional[int] = None,
        seed: Optional[int] = None,
    ) -> Dict[str, np.ndarray]:
        """Posterior mean/std/variance maps for one LR patch."""
        return self._post_array(
            "/v1/uncertainty", lr, samples=samples, chunk=chunk, seed=seed
        )

    def uncertainty_tile(
        self, lr, samples: Optional[int] = None, overlap: Optional[int] = None,
        batch: Optional[int] = None, seed: Optional[int] = None,
    ) -> Dict[str, np.ndarray]:
        """Posterior mean/std/variance maps for one arbitrary-size raster."""
        return self._post_array(
            "/v1/uncertainty_tile", lr,
            samples=samples, overlap=overlap, batch=batch, seed=seed,
        )

    def resolver(self, normalize: bool = True,
                 pipeline: Optional[int] = None) -> "RemoteResolver":
        """Client-side tile endpoints bound to this server (see below).

        ``pipeline`` bounds the number of in-flight posts the tile/stream
        sweeps keep (default: the sweeps' own dispatch depth); ``0`` makes
        every post synchronous."""
        info = self.health()
        if self.wire == "u16" and not info.get("wire_u16"):
            # a pre-u16 server 400s on the npz body mid-sweep; refuse at
            # construction instead (same pattern as the seed guard)
            raise ServerError(
                "this server predates the u16 wire (/healthz has no "
                "'wire_u16' capability) — use wire='f32' against it"
            )
        return RemoteResolver(
            self, window=int(info["patch_size"]) // 2,
            channels=info.get("channels"), normalize=normalize,
            moments=bool(info.get("moments")),
            seed_support=bool(info.get("seed")),
            pipeline=pipeline,
        )


class _Deferred:
    """An in-flight POST's result: materializes (blocks) on first use.

    ``RemoteResolver``'s async dispatch hooks return these so the
    ``TileEndpoints`` sweep loops can keep several posts in flight before
    touching the oldest result — the same overlap those loops get from
    asynchronous CUDA launches on a local resolver. Implements exactly the
    accesses the loops perform on a pending result: ``shape``, slicing,
    and ``np.asarray``. A failed POST (after the client's retries)
    surfaces its ``ServerError`` at the fetch site, same as a synchronous
    call — just later.
    """

    __slots__ = ("_future", "_pick")

    def __init__(self, future, pick: Optional[int] = None) -> None:
        self._future = future
        self._pick = pick  # selects one element of a tuple-valued POST

    def _value(self) -> np.ndarray:
        out = self._future.result()
        return out if self._pick is None else out[self._pick]

    @property
    def shape(self):
        return self._value().shape

    def __getitem__(self, key):
        return self._value()[key]

    def __array__(self, dtype=None, copy=None):
        arr = self._value()
        if dtype is not None and arr.dtype != np.dtype(dtype):
            arr = arr.astype(dtype)
        return arr


class RemoteResolver(TileEndpoints):
    """Client-side whole-raster endpoints over a remote model server.

    The server's ``/v1/*_tile`` endpoints ship the WHOLE raster in one
    request — right for tiles, wrong for scenes (both sides must
    materialize the raster and the relay pays one giant body). This
    adapter runs the window grid / feather stitch (``tiling.
    TileEndpoints`` — the same code the server's own resolver uses) on
    the CLIENT and posts only model-window batches, so
    ``iter_tile_rows`` streams an arbitrarily large scene against a
    remote accelerator with bounded memory on BOTH sides. Construct via
    ``Client(url).resolver()`` (window size from ``/healthz``).

    Window-batch posts are PIPELINED by default: the tile/stream sweeps
    dispatch through ``super_resolve_async`` / ``super_resolve_moments_
    async``, which post on a bounded thread pool and return lazy results,
    so serializing + uploading batch k+1 overlaps the server's compute on
    batch k (the server reads request bodies concurrently and serializes
    only the device dispatch). On a high-latency link a sweep's wall time
    drops toward max(transfer, compute) instead of their sum. Results
    stitch by window index, so pipelining never reorders the product;
    seeded sweeps stay bitwise-reproducible because every dispatch's seed
    is a pure function of its position (``tiling.subseed``). ``pipeline=0``
    restores strictly serial posts; direct ``super_resolve(...)`` calls
    are synchronous either way.
    """

    def __init__(self, client: Client, window: int,
                 channels: Optional[int] = None, normalize: bool = True,
                 moments: bool = False, seed_support: bool = True,
                 pipeline: Optional[int] = None) -> None:
        self._client = client
        self._window_px = int(window)
        self.channels = channels
        self.normalize = normalize
        # pre-seed servers ignore an unknown `seed` param, which would
        # silently break the reproducibility contract — refuse instead
        # (/healthz advertises support via its `seed` field)
        self._seed_support = bool(seed_support)
        depth = TileEndpoints._TILE_PIPELINE if pipeline is None \
            else max(0, int(pipeline))
        self._pool = None
        if depth > 0:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(
                max_workers=depth, thread_name_prefix="svrs-post")
        if not moments:
            # older server without /v1/super_resolve_moments: a None
            # instance attribute masks the method below, so the
            # TileEndpoints mixin packs (window, draw) pairs client-side
            self.super_resolve_moments = None  # type: ignore[assignment]

    def close(self) -> None:
        """Stop the post pool (in-flight posts are abandoned, not joined).
        Harmless to skip — the pool's threads are idle between sweeps —
        but lets long-lived processes reclaim them deterministically."""
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None

    @property
    def window(self) -> int:
        return self._window_px

    def _check_seed(self, seed: Optional[int]) -> None:
        if seed is not None and not self._seed_support:
            raise ServerError(
                "this server predates per-request seeds (/healthz has no "
                "'seed' capability) — it would silently ignore the param"
            )

    def super_resolve(self, lr, normalize: Optional[bool] = None,
                      seed: Optional[int] = None) -> np.ndarray:
        self._check_seed(seed)
        kw = {} if seed is None else {"seed": seed}
        return self._client.super_resolve(
            lr, normalize=self.normalize if normalize is None else normalize,
            **kw,
        )

    def super_resolve_moments(self, wins, samples: int,
                              normalize: bool = False,
                              seed: Optional[int] = None) -> tuple:
        """Device-moments hook for the tile/stream UQ paths: a window
        batch's ``samples``-draw statistics come back as TWO moment maps
        (one POST), not ``samples`` SR draws — on a whole-scene sweep the
        response traffic drops by the sample count."""
        self._check_seed(seed)
        kw = {} if seed is None else {"seed": seed}
        return self._client.super_resolve_moments(
            wins, samples, normalize=normalize, **kw
        )

    # -------------------------------------------- pipelined dispatch hooks
    # The TileEndpoints sweeps prefer these (tiling._dispatch_fn /
    # _moments_hook): each returns immediately with lazy result(s) while
    # the POST runs on the pool, so up to _TILE_PIPELINE posts are in
    # flight before the oldest is materialized. Inputs are snapshotted
    # (asarray of a fresh chunk) before submission, so the sweep loop may
    # reuse its buffers freely.
    def super_resolve_async(self, lr, normalize: Optional[bool] = None,
                            seed: Optional[int] = None):
        if self._pool is None:
            return self.super_resolve(lr, normalize=normalize, seed=seed)
        self._check_seed(seed)
        kw = {} if seed is None else {"seed": seed}
        norm = self.normalize if normalize is None else normalize
        lr = np.asarray(lr, np.float32)
        return _Deferred(self._pool.submit(
            self._client.super_resolve, lr, normalize=norm, **kw))

    def super_resolve_moments_async(self, wins, samples: int,
                                    normalize: bool = False,
                                    seed: Optional[int] = None) -> tuple:
        if self._pool is None:
            return self.super_resolve_moments(
                wins, samples, normalize=normalize, seed=seed)
        self._check_seed(seed)
        kw = {} if seed is None else {"seed": seed}
        wins = np.asarray(wins, np.float32)
        fut = self._pool.submit(
            self._client.super_resolve_moments, wins, samples,
            normalize=normalize, **kw)
        return _Deferred(fut, pick=0), _Deferred(fut, pick=1)
