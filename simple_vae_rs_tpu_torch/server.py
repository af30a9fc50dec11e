"""HTTP model server: the port's SuperResolver behind a stdlib HTTP front end.

Load a checkpoint once, keep the model resident on the card, answer
requests over HTTP. Standard library only: ``ThreadingHTTPServer`` reads
requests concurrently while one lock serialises dispatch (one model, one
card; the resolver's rolling generator advances under it). With
``--dynamic_batch_ms`` the ``/v1/super_resolve`` endpoint merges
concurrent requests into shared power-of-two-bucketed dispatches
(``batching.MicroBatcher``). Every reply array is copied to the host as
float32 (``tiling.to_host``).

Endpoints (all arrays NHWC, channels last):

- ``GET /healthz`` -> ``{"status": "ok", "model": ..., "patch_size": ...}``
  and the capability keys ``moments``, ``seed`` and ``wire_u16``.
- ``GET /metrics`` -> Prometheus text: requests and latency by endpoint.
- ``POST /v1/super_resolve`` -> one posterior draw of an LR batch.
- ``POST /v1/super_resolve_moments`` -> per-pixel sum and sum of squares
  over ``samples`` draws of an LR window batch (the streaming UQ client's
  path: two maps a batch instead of every draw).
- ``POST /v1/super_resolve_tile`` -> seam-free SR of ONE LR raster of any
  size (window grid + feathered stitch; ``overlap``/``batch``/``samples``).
- ``POST /v1/uncertainty``  -> mean/std/variance maps of one LR image
  (``samples``/``chunk``).
- ``POST /v1/uncertainty_tile`` -> the same maps of one LR raster of any
  size (``samples``/``overlap``/``batch``).

Three body encodings, by Content-Type: ``application/json`` (``{"lr":
[[...]], ...}``, reply JSON), ``application/x-npy`` (the ``.npy`` bytes of
the LR array; reply ``.npy`` or a multi-array ``.npz``) and
``application/x-npz`` (an ``lr`` entry, plain float32 or u16-quantized
with ``lr__lo``/``lr__hi`` companions, ``wire.py``). A binary request may
ask for a u16 reply with ``wire=u16``. Options ride the query string on
any encoding; JSON body fields win over it. Every model endpoint takes
``seed``: the request's draws come from it alone, so the same input, seed
and options reproduce the reply; seeded ``/v1/super_resolve`` requests
bypass the micro-batcher. The protocol is the JAX package's server's, so
either package's client drives it.

Launch (the card by default; ``--backend cpu`` runs the plain CPU path)::

    python -m simple_vae_rs_tpu_torch.server --model_ckpt ckpt/job \
        --port 8471 [--int8 | --int8_weights] [--dynamic_batch_ms 2]

``--artifact OUT`` serves a ``torch.export`` artifact (``export.py``) instead
of a checkpoint: ``/healthz`` then answers the JAX server's artifact keys.
``--mesh_data N`` serves from one replica per card over the first N cards
(``parallel/mesh``: each request split over them; on ``--backend cpu``, N
replicas on the host), raising with the JAX message where there are fewer;
``/healthz`` reports the mesh's shape. Not ported, raising:
``--pallas_conv`` (every conv runs its CUDA kernel).
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple
from urllib.parse import parse_qs, urlsplit

import numpy as np

from simple_vae_rs_tpu_torch.serve import SuperResolver, backend_device, warmup
from simple_vae_rs_tpu_torch.tiling import to_host

_JSON = "application/json"
_NPY = "application/x-npy"
_NPZ = "application/x-npz"


class Metrics:
    """Prometheus-style request telemetry, stdlib only.

    Counts and latency histograms per endpoint, rendered in the
    text exposition format at ``GET /metrics`` — enough for a scrape
    target in a production deployment without adding a dependency.
    """

    _BUCKETS = (0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._stats: Dict[str, Dict[str, Any]] = {}

    def observe(self, endpoint: str, seconds: float, error: bool = False) -> None:
        with self._lock:
            s = self._stats.setdefault(endpoint, {
                "ok": 0, "error": 0, "sum": 0.0,
                "buckets": [0] * (len(self._BUCKETS) + 1),
            })
            s["error" if error else "ok"] += 1
            s["sum"] += seconds
            for i, le in enumerate(self._BUCKETS):
                if seconds <= le:
                    s["buckets"][i] += 1
                    break
            else:
                s["buckets"][-1] += 1

    def render(self) -> str:
        lines = [
            "# HELP svrs_requests_total requests served, by endpoint/outcome",
            "# TYPE svrs_requests_total counter",
        ]
        with self._lock:
            items = sorted(self._stats.items())
            for ep, s in items:
                for outcome in ("ok", "error"):
                    lines.append(
                        f'svrs_requests_total{{endpoint="{ep}",'
                        f'outcome="{outcome}"}} {s[outcome]}'
                    )
            lines += [
                "# HELP svrs_request_duration_seconds request latency",
                "# TYPE svrs_request_duration_seconds histogram",
            ]
            for ep, s in items:
                cum = 0
                for le, n in zip(self._BUCKETS, s["buckets"]):
                    cum += n
                    lines.append(
                        f'svrs_request_duration_seconds_bucket{{endpoint='
                        f'"{ep}",le="{le}"}} {cum}'
                    )
                cum += s["buckets"][-1]
                lines.append(
                    f'svrs_request_duration_seconds_bucket{{endpoint='
                    f'"{ep}",le="+Inf"}} {cum}'
                )
                lines.append(
                    f'svrs_request_duration_seconds_sum{{endpoint="{ep}"}} '
                    f'{s["sum"]:.6f}'
                )
                lines.append(
                    f'svrs_request_duration_seconds_count{{endpoint="{ep}"}} '
                    f'{cum}'
                )
        return "\n".join(lines) + "\n"


class DeviceProber:
    """Resident device liveness monitor (``--probe_device N``).

    A replica whose card hangs looks alive to TCP health checks while every
    model request blocks. ONE daemon thread runs a trivial op on the
    resolver's device every ``interval_s`` (synchronized on a card) and
    timestamps the success; ``status()`` derives health from the
    heartbeat's age. A hung dispatch blocks the loop thread (no thread
    leak), the heartbeat goes stale and ``/healthz`` turns ``"degraded"``
    (HTTP 503) so a readiness probe takes the replica out; when the device
    recovers, the heartbeat resumes. The op is independent of the model,
    so it measures the device and runtime, not model latency.
    """

    def __init__(self, interval_s: float, device) -> None:
        import time

        self.device = device
        self.interval = float(interval_s)
        # a healthy loop heartbeats every ~interval (+ probe latency);
        # allow two missed beats plus headroom for a slow dispatch
        self.stale_after = 2.0 * self.interval + 60.0
        self._lock = threading.Lock()
        self._last: Optional[Tuple[float, float]] = None
        self._started = time.monotonic()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="svrs-device-probe"
        )
        self._thread.start()

    def _dispatch(self) -> None:
        """One trivial device round trip (tests stub this)."""
        import torch

        x = torch.zeros((8, 128), device=self.device) + 1
        if x.device.type == "cuda":
            torch.cuda.synchronize(x.device)
        float(x.sum())

    def _loop(self) -> None:
        import time

        while not self._stop.is_set():
            t0 = time.monotonic()
            try:
                self._dispatch()
                with self._lock:
                    self._last = (time.monotonic(), time.monotonic() - t0)
            except Exception:
                pass  # no heartbeat IS the signal
            self._stop.wait(self.interval)

    def status(self) -> Dict[str, Any]:
        import time

        now = time.monotonic()
        with self._lock:
            last = self._last
        if last is None:
            age = now - self._started
            return {"ok": age < self.stale_after, "age_s": round(age, 1),
                    "latency_ms": None}
        ts, lat = last
        age = now - ts
        return {"ok": age < self.stale_after, "age_s": round(age, 1),
                "latency_ms": round(lat * 1000.0, 1)}

    def close(self) -> None:
        self._stop.set()


class ModelService:
    """Request-level wrapper: decode body -> resolver call -> encode body."""

    def __init__(self, resolver: SuperResolver,
                 max_body_mb: int = 512, token: str = "",
                 access_log: bool = False,
                 dynamic_batch_ms: float = 0.0,
                 max_batch: int = 64,
                 probe_device_s: float = 0.0) -> None:
        self.resolver = resolver
        self.lock = threading.Lock()
        self.metrics = Metrics()
        self.max_body_bytes = int(max_body_mb) << 20
        self.prober = DeviceProber(probe_device_s, resolver.device) \
            if probe_device_s > 0 else None
        self.batcher = None
        if dynamic_batch_ms > 0:
            from simple_vae_rs_tpu_torch.batching import MicroBatcher

            def _dispatch(lr, normalize):
                with self.lock:
                    return to_host(self.resolver.super_resolve(lr, normalize=normalize))

            self.batcher = MicroBatcher(
                _dispatch, max_batch=max_batch,
                max_delay_ms=dynamic_batch_ms,
            )
        # static bearer token for the model endpoints (healthz/metrics stay
        # open so probes and scrapers need no secret); compared
        # constant-time. Transport security is the deployment's job (put a
        # TLS terminator in front for non-loopback traffic).
        self.token = token
        self.access_log = access_log

    # ------------------------------------------------------------- decoding
    def _decode(
        self, body: bytes, ctype: str, query: Optional[Dict[str, Any]] = None
    ) -> Tuple[np.ndarray, Dict[str, Any]]:
        """(lr array, options). Options merge query-string params (the
        side channel that keeps the binary npy body viable when options
        ride along — whole-raster payloads as JSON lists are ~4x the
        bytes plus a float text round trip) under any JSON body fields
        (explicit body wins)."""
        if ctype.startswith(_NPY):
            arr = np.load(io.BytesIO(body), allow_pickle=False)
            return np.asarray(arr, np.float32), dict(query or {})
        if ctype.startswith(_NPZ):
            # npz body: `lr` entry, plain f32 or u16-wire quantized
            # (uint16 + lr__lo/lr__hi companions; wire.decode_arrays
            # handles both). Dequantization is float32 throughout, so the
            # server reconstructs the exact values the client computed.
            # An npz is a zip whose entries may be deflated, so
            # Content-Length alone cannot bound host memory (a ~100 KB
            # body of zero-filled arrays inflates to hundreds of MB) —
            # read ONLY the expected entries, each through a bounded
            # reader that charges a shared max_body_bytes budget.
            import zipfile

            from simple_vae_rs_tpu_torch import wire

            entries: Dict[str, np.ndarray] = {}
            budget = self.max_body_bytes
            try:
                with zipfile.ZipFile(io.BytesIO(body)) as zf:
                    infos = [i for i in zf.infolist()
                             if (i.filename[:-4] if i.filename.endswith(
                                 ".npy") else i.filename)
                             in ("lr", "lr__lo", "lr__hi")]
                    # metadata pre-check refuses an honest bomb without
                    # decompressing a byte...
                    if sum(i.file_size for i in infos) > budget:
                        raise ValueError(
                            "npz entries exceed the body limit after "
                            "decompression (--max_body_mb)")
                    for info in infos:
                        name = info.filename
                        key = name[:-4] if name.endswith(".npy") else name
                        # duplicate entries would decode bytes other than
                        # the ones the metadata pre-check vetted
                        if key in entries:
                            raise ValueError(
                                f"duplicate npz entry {name!r}")
                        # ...and the bounded read holds the line against
                        # a lying zip header; open by ZipInfo so the bytes
                        # read are the entry that was vetted
                        with zf.open(info) as fh:
                            data = fh.read(budget + 1)
                            if len(data) > budget:
                                raise ValueError(
                                    "npz entry exceeds the body limit "
                                    "after decompression (--max_body_mb)")
                            budget -= len(data)
                        entries[key] = np.load(
                            io.BytesIO(data), allow_pickle=False)
            except zipfile.BadZipFile as e:
                raise ValueError(f"bad npz body: {e}") from None
            if "lr" not in entries:
                raise ValueError("npz body is missing the 'lr' entry")
            arr = wire.decode_arrays(entries)["lr"]
            if not np.issubdtype(arr.dtype, np.floating):
                # a u16-wire body that lost its __lo/__hi companions would
                # otherwise feed 0..65535-valued integers to the model as
                # a plausible-looking float batch
                raise ValueError(
                    "non-float 'lr' entry (a quantized body must carry "
                    "both lr__lo and lr__hi companions)")
            return np.asarray(arr, np.float32), dict(query or {})
        payload = json.loads(body.decode("utf-8"))
        if "lr" not in payload:
            raise ValueError("missing 'lr' field")
        return np.asarray(payload["lr"], np.float32), {**(query or {}), **payload}

    @staticmethod
    def _encode(arrays: Dict[str, np.ndarray], ctype: str,
                wire_opt: str = "") -> Tuple[bytes, str]:
        if ctype.startswith(_NPY) or ctype.startswith(_NPZ):
            buf = io.BytesIO()
            if wire_opt == "u16":
                from simple_vae_rs_tpu_torch import wire

                try:
                    quantized = wire.encode_arrays_u16(arrays)
                except ValueError as e:
                    # a non-finite MODEL OUTPUT is the server's condition,
                    # not the caller's — surface as a 500 (which clients
                    # retry: an unseeded bad draw is transient), not the
                    # 400 the generic ValueError handler would emit
                    raise RuntimeError(
                        f"cannot u16-encode the response: {e}") from None
                np.savez(buf, **quantized)
                return buf.getvalue(), _NPZ
            if len(arrays) == 1:
                np.save(buf, next(iter(arrays.values())))
                return buf.getvalue(), _NPY
            np.savez(buf, **arrays)
            return buf.getvalue(), _NPZ
        return (
            json.dumps({k: v.tolist() for k, v in arrays.items()}).encode(),
            _JSON,
        )

    @staticmethod
    def _wire_of(payload: Dict[str, Any]) -> str:
        """Validated ``wire`` response-encoding option ("" = float32)."""
        from simple_vae_rs_tpu_torch import wire

        opt = str(payload.get("wire") or "")
        if opt not in wire.WIRE_VALUES:
            raise ValueError(
                f"unknown wire={opt!r} (use one of {wire.WIRE_VALUES[1:]})")
        return opt if opt == wire.WIRE_U16 else ""

    # ------------------------------------------------------------ endpoints
    def health(self) -> Dict[str, Any]:
        r = self.resolver
        moments = callable(getattr(r, "super_resolve_moments", None))
        if hasattr(r, "meta") and not hasattr(r, "model"):  # export.ExportedResolver
            out: Dict[str, Any] = {
                "status": "ok",
                "model": str(r.meta.get("model_type")),
                "patch_size": int(r.meta["patch_size"]),
                "channels": int(r.meta["channels"]),
                "artifact": True,
                "batch": int(r.batch),
                # the JAX server names the artifact's lowering platforms here;
                # a port artifact is device-neutral and runs where it was loaded
                "platforms": [r.device.type],
                "moments": moments,
                "seed": True,
                "wire_u16": True,
            }
        else:
            out = {
                "status": "ok",
                "model": type(r.model).__name__,
                "patch_size": int(r.model.config.patch_size),
                "channels": int(r.model.config.channels),
                "int8": bool(r.int8),
                "int8_weights": bool(getattr(r, "int8_weights", False)),
                "mesh": dict(r.mesh.shape) if getattr(r, "mesh", None) is not None else None,
                "moments": moments,
                "seed": True,
                "wire_u16": True,
            }
        if self.prober is not None:
            dev = self.prober.status()
            out["device"] = dev
            if not dev["ok"]:
                # readiness consumers key off status != "ok": a replica
                # whose device hangs must rotate out even
                # though its HTTP front end still answers
                out["status"] = "degraded"
        return out

    @staticmethod
    def _seed_of(payload: Dict[str, Any]) -> Dict[str, int]:
        """Optional per-request reproducibility seed, as forwardable
        kwargs ({} when absent, so wrapped/legacy resolvers that predate
        the ``seed`` kwarg keep working unseeded)."""
        seed = payload.get("seed")
        if seed is None:
            return {}
        seed = int(seed)
        if seed < 0:
            # one rule for every endpoint (tiling.subseed would reject a
            # negative seed deep inside the tile sweep anyway) -> 400
            raise ValueError(f"seed must be a non-negative integer (got {seed})")
        return {"seed": seed}

    def super_resolve(self, body: bytes, ctype: str, query=None) -> Tuple[bytes, str]:
        lr, payload = self._decode(body, ctype, query)
        wire_opt = self._wire_of(payload)  # validate BEFORE dispatch
        normalize = payload.get("normalize")  # None -> resolver default
        if normalize is not None:
            # query-string values arrive as strings ("0"/"1"); remote tile
            # sweeps send pre-normalized windows with normalize=0
            normalize = str(normalize).lower() not in ("0", "false", "no")
        seed_kw = self._seed_of(payload)
        if self.batcher is not None and not seed_kw:
            # coalesce with concurrent requests into one device dispatch
            # (seeded requests dispatch privately: a merged batch shares
            # one draw, which would tie the response to its co-riders)
            out = self.batcher.submit(lr, normalize)
        else:
            with self.lock:
                out = to_host(self.resolver.super_resolve(lr, normalize=normalize, **seed_kw))
        return self._encode({"sr": out}, ctype, wire_opt)

    def super_resolve_tile(self, body: bytes, ctype: str, query=None) -> Tuple[bytes, str]:
        lr, payload = self._decode(body, ctype, query)
        wire_opt = self._wire_of(payload)  # validate BEFORE dispatch
        overlap = payload.get("overlap")  # None -> min(4, window//2)
        overlap = int(overlap) if overlap is not None else None
        batch = int(payload.get("batch", 16))
        samples = int(payload.get("samples", 1))
        with self.lock:
            out = to_host(
                self.resolver.super_resolve_tile(
                    lr, overlap=overlap, batch=batch, samples=samples,
                    **self._seed_of(payload),
                )
            )
        return self._encode({"sr": out}, ctype, wire_opt)

    def uncertainty_tile(self, body: bytes, ctype: str, query=None) -> Tuple[bytes, str]:
        lr, payload = self._decode(body, ctype, query)
        wire_opt = self._wire_of(payload)  # validate BEFORE dispatch
        samples = int(payload.get("samples", 32))
        overlap = payload.get("overlap")  # None -> min(4, window//2)
        overlap = int(overlap) if overlap is not None else None
        batch = int(payload.get("batch", 16))
        with self.lock:
            maps = self.resolver.uncertainty_tile(
                lr, samples=samples, overlap=overlap, batch=batch,
                **self._seed_of(payload),
            )
        return self._encode({k: to_host(v) for k, v in maps.items()}, ctype, wire_opt)

    def super_resolve_moments(self, body: bytes, ctype: str, query=None) -> Tuple[bytes, str]:
        """Device-reduced draw moments for a window batch: (B, ps/2, ps/2, C)
        LR windows -> npz of ``s1``/``s2`` (B, ps, ps, C), the per-pixel sum
        and sum-of-squares over ``samples`` posterior draws. This is the
        remote form of the resolver's ``super_resolve_moments`` hook — a
        streaming UQ client gets a whole window batch's statistics as TWO
        maps instead of posting/fetching every draw (``samples``x less
        response traffic). 400 if the serving resolver has no moments hook
        (``/healthz`` advertises ``moments`` so clients fall back to draw
        packing without a probe request)."""
        hook = getattr(self.resolver, "super_resolve_moments", None)
        if not callable(hook):
            raise ValueError(
                "this server's resolver has no device-side moments hook; "
                "draw via /v1/super_resolve instead"
            )
        lr, payload = self._decode(body, ctype, query)
        wire_opt = self._wire_of(payload)  # validate BEFORE dispatch
        samples = int(payload.get("samples", 32))
        normalize = payload.get("normalize")
        normalize = (
            str(normalize).lower() not in ("0", "false", "no")
            if normalize is not None else False
        )
        with self.lock:
            s1, s2 = hook(lr, samples, normalize=normalize,
                          **self._seed_of(payload))
            s1, s2 = to_host(s1), to_host(s2)
        return self._encode({"s1": s1, "s2": s2}, ctype,
                            wire_opt)

    def uncertainty(self, body: bytes, ctype: str, query=None) -> Tuple[bytes, str]:
        lr, payload = self._decode(body, ctype, query)
        wire_opt = self._wire_of(payload)  # validate BEFORE dispatch
        samples = int(payload.get("samples", 32))
        chunk = payload.get("chunk")  # None -> tasks.auto_chunk
        chunk = int(chunk) if chunk is not None else None
        with self.lock:
            maps = self.resolver.uncertainty(
                lr, samples=samples, chunk=chunk,
                **self._seed_of(payload),
            )
        return self._encode({k: to_host(v) for k, v in maps.items()}, ctype, wire_opt)


class _Handler(BaseHTTPRequestHandler):
    service: ModelService  # injected by make_server

    def log_message(self, fmt, *args):  # quiet unless --access_log
        if getattr(self.service, "access_log", False):
            sys.stderr.write(
                f"{self.address_string()} [{self.log_date_time_string()}] "
                f"{fmt % args}\n"
            )

    def _reply(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _fail(self, code: int, message: str) -> None:
        self._reply(code, json.dumps({"error": message}).encode(), _JSON)

    def do_GET(self):  # noqa: N802 (stdlib handler API)
        if self.path == "/healthz":
            info = self.service.health()
            # HTTP-code-based readiness probes (k8s httpGet treats any 2xx
            # as ready) must see the degraded state, not just body parsers
            code = 200 if info.get("status") == "ok" else 503
            self._reply(code, json.dumps(info).encode(), _JSON)
        elif self.path == "/metrics":
            text = self.service.metrics.render()
            if self.service.batcher is not None:
                text += self.service.batcher.render_metrics()
            if self.service.prober is not None:
                dev = self.service.prober.status()
                text += (
                    "# HELP svrs_device_probe_ok 1 while the accelerator "
                    "heartbeat is fresh\n"
                    "# TYPE svrs_device_probe_ok gauge\n"
                    f"svrs_device_probe_ok {int(dev['ok'])}\n"
                    "# HELP svrs_device_probe_age_seconds seconds since "
                    "the last successful device round trip\n"
                    "# TYPE svrs_device_probe_age_seconds gauge\n"
                    f"svrs_device_probe_age_seconds {dev['age_s']}\n"
                )
                if dev["latency_ms"] is not None:
                    text += (
                        "# HELP svrs_device_probe_latency_seconds last "
                        "probe round trip\n"
                        "# TYPE svrs_device_probe_latency_seconds gauge\n"
                        f"svrs_device_probe_latency_seconds "
                        f"{dev['latency_ms'] / 1000.0:.6f}\n"
                    )
            self._reply(200, text.encode(), "text/plain; version=0.0.4")
        else:
            self._fail(404, f"unknown path {self.path}")

    def do_POST(self):  # noqa: N802
        import time

        routes = {
            "/v1/super_resolve": self.service.super_resolve,
            "/v1/super_resolve_moments": self.service.super_resolve_moments,
            "/v1/super_resolve_tile": self.service.super_resolve_tile,
            "/v1/uncertainty": self.service.uncertainty,
            "/v1/uncertainty_tile": self.service.uncertainty_tile,
        }
        split = urlsplit(self.path)
        handler = routes.get(split.path)
        if handler is None:
            self._fail(404, f"unknown path {self.path}")
            return
        if self.service.token:
            import hmac

            got = self.headers.get("Authorization", "")
            want = f"Bearer {self.service.token}"
            if not hmac.compare_digest(got, want):
                self.service.metrics.observe(split.path, 0.0, error=True)
                self._fail(401, "missing or invalid bearer token")
                return
        t0 = time.perf_counter()
        try:
            query = {k: v[-1] for k, v in parse_qs(split.query).items()}
            length = int(self.headers.get("Content-Length", 0))
            if length > self.service.max_body_bytes:
                # refuse without BUFFERING: an oversized raster body would
                # OOM the host long before the model sees it (the
                # streaming tile sweeps post window batches instead).
                # Drain it in bounded chunks so the client finishes
                # sending and actually receives the 413 (closing mid-send
                # surfaces as a broken pipe instead of the error reply).
                remaining = length
                while remaining > 0:
                    chunk = self.rfile.read(min(1 << 20, remaining))
                    if not chunk:
                        break
                    remaining -= len(chunk)
                self.service.metrics.observe(
                    split.path, time.perf_counter() - t0, error=True)
                self._fail(413, f"body of {length} bytes exceeds the "
                           f"{self.service.max_body_bytes}-byte limit "
                           f"(--max_body_mb; or stream window batches)")
                return
            body = self.rfile.read(length)
            ctype = self.headers.get("Content-Type", _JSON)
            out, out_type = handler(body, ctype, query)
            self.service.metrics.observe(
                split.path, time.perf_counter() - t0)
            self._reply(200, out, out_type)
        except (ValueError, KeyError, json.JSONDecodeError) as e:
            self.service.metrics.observe(
                split.path, time.perf_counter() - t0, error=True)
            self._fail(400, str(e))
        except Exception as e:  # pragma: no cover - defensive 500
            self.service.metrics.observe(
                split.path, time.perf_counter() - t0, error=True)
            self._fail(500, f"{type(e).__name__}: {e}")


def make_server(
    resolver: SuperResolver, host: str = "127.0.0.1", port: int = 8471,
    max_body_mb: int = 512, token: str = "", access_log: bool = False,
    dynamic_batch_ms: float = 0.0, max_batch: int = 64,
    probe_device_s: float = 0.0,
) -> ThreadingHTTPServer:
    """Build (but don't start) the HTTP server around a resolver.

    ``dynamic_batch_ms > 0`` coalesces concurrent ``/v1/super_resolve``
    requests into shared device dispatches (see ``batching.MicroBatcher``);
    ``probe_device_s > 0`` runs the resident accelerator heartbeat
    (``DeviceProber`` — /healthz turns ``"degraded"`` when it goes
    stale). The returned server's ``server_close`` also stops both
    background threads.
    """
    service = ModelService(resolver, max_body_mb=max_body_mb, token=token,
                           access_log=access_log,
                           dynamic_batch_ms=dynamic_batch_ms,
                           max_batch=max_batch,
                           probe_device_s=probe_device_s)
    handler = type("BoundHandler", (_Handler,), {"service": service})
    server = ThreadingHTTPServer((host, port), handler)
    if service.batcher is not None or service.prober is not None:
        base_close = server.server_close

        def _close() -> None:
            base_close()
            if service.batcher is not None:
                service.batcher.close()
            if service.prober is not None:
                service.prober.close()

        server.server_close = _close  # type: ignore[method-assign]
    return server


def main(argv: Optional[list] = None) -> None:
    p = argparse.ArgumentParser(description="simple-vae-rs-tpu model server (PyTorch port)")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--model_ckpt", default=None)
    src.add_argument("--artifact", default=None,
                     help="serve a torch.export artifact (export.py output) instead of a "
                     "checkpoint: kernel, mesh and model-config flags do not apply (the "
                     "graph is fixed at export time)")
    # model-config flags default to the config recorded in the checkpoint's
    # meta; flags override (see SuperResolver.from_checkpoint)
    p.add_argument("-cr", "--compression_ratio", type=float, default=None)
    p.add_argument("--patch_size", type=int, default=None)
    p.add_argument("--channels", type=int, default=None)
    p.add_argument("--latent_size", type=int, default=None,
                   help="Fixed latent budget overriding the cr formula "
                   "(must match the trained checkpoint's config).")
    p.add_argument("--model_type", default=None, choices=["Cond_SRVAE", "SRVAE"])
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8471)
    p.add_argument("--int8", action="store_true",
                   help="serve the W8A8 decoder (int8 kernels, activations quantized in "
                   "the call)")
    p.add_argument("--int8_weights", action="store_true",
                   help="weights-only int8: kernels quantized at load, dequantized per "
                   "request")
    p.add_argument("--pallas_conv", action="store_true",
                   help="not ported: every conv runs its CUDA kernel")
    p.add_argument("--mesh_data", type=int, default=1,
                   help="serve from a replica per card over this many cards (the host "
                   "with --backend cpu), each request split over them")
    p.add_argument("--no_warmup", action="store_true")
    p.add_argument("--max_body_mb", type=int, default=512,
                   help="refuse request bodies over this size with a 413 "
                   "(streaming clients post window batches and never get near it)")
    p.add_argument("--token", default=os.environ.get("SVRS_TOKEN", ""),
                   help="require this bearer token on the model endpoints "
                   "(healthz/metrics stay open; default $SVRS_TOKEN; "
                   "empty = no auth — put TLS in front for non-loopback)")
    p.add_argument("--access_log", action="store_true",
                   help="log one line per request to stderr")
    p.add_argument("--dynamic_batch_ms", type=float, default=0.0,
                   help="coalesce concurrent /v1/super_resolve requests arriving within "
                   "this window into one dispatch (pow2-bucketed batch shapes; 0 = off)")
    p.add_argument("--max_batch", type=int, default=64,
                   help="row cap per coalesced dispatch (--dynamic_batch_ms)")
    p.add_argument("--probe_device", type=float, default=0.0,
                   help="device heartbeat: run a trivial op on the device every N "
                   "seconds; when it goes stale, /healthz turns 'degraded' so readiness "
                   "probes rotate the replica out. 0 = off")
    p.add_argument("--backend", default="",
                   help="'cpu' runs the plain CPU path; default: the CUDA card")
    args = p.parse_args(argv)
    device = backend_device(args.backend)
    if args.artifact:
        baked = [name for name, val in [
            ("--int8", args.int8), ("--int8_weights", args.int8_weights),
            ("--pallas_conv", args.pallas_conv),
            ("--mesh_data", args.mesh_data > 1),
            ("-cr", args.compression_ratio is not None),
            ("--patch_size", args.patch_size is not None),
            ("--channels", args.channels is not None),
            ("--latent_size", args.latent_size is not None),
            ("--model_type", args.model_type is not None),
        ] if val]
        if baked:
            p.error(f"{', '.join(baked)} cannot apply to --artifact serving: the exported "
                    "graph is fixed at export time")
        from simple_vae_rs_tpu_torch.export import load_exported

        resolver = load_exported(args.artifact, device=device)
        if not args.no_warmup:
            # one dispatch, and a moments request at the tile endpoints'
            # default draw count
            w, c = resolver.window, int(resolver.meta["channels"])
            resolver.super_resolve(np.zeros((1, w, w, c), np.float32))
            resolver.super_resolve_moments(np.zeros((1, w, w, c), np.float32), 32)
        served = f"artifact {resolver.meta.get('model_type')}"
    else:
        mesh = None
        if args.mesh_data > 1:
            import torch

            from simple_vae_rs_tpu_torch.config import MeshConfig
            from simple_vae_rs_tpu_torch.parallel.mesh import make_mesh

            devices = (["cpu"] * args.mesh_data if device == "cpu" else
                       [f"cuda:{i}" for i in range(torch.cuda.device_count())])
            mesh = make_mesh(MeshConfig(data=args.mesh_data, model=1), devices)
        if args.pallas_conv:
            raise ValueError("--pallas_conv is not ported, on purpose: every conv runs its "
                             "CUDA kernel (ROADMAP A.3)")
        resolver = SuperResolver.from_checkpoint(
            args.model_ckpt,
            cr=args.compression_ratio,
            patch_size=args.patch_size,
            channels=args.channels,
            latent_size=args.latent_size,
            model_type=args.model_type,
            int8=args.int8,
            int8_weights=args.int8_weights,
            device=device,
            mesh=mesh,
        )
        cfg = resolver.model.config
        if not args.no_warmup:
            lr_side = int(cfg.patch_size) // 2
            warmup(resolver, lr_shape=(1, lr_side, lr_side, int(cfg.channels)))
        served = type(resolver.model).__name__
    server = make_server(resolver, args.host, args.port,
                         max_body_mb=args.max_body_mb, token=args.token,
                         access_log=args.access_log,
                         dynamic_batch_ms=args.dynamic_batch_ms,
                         max_batch=args.max_batch,
                         probe_device_s=args.probe_device)
    print(f"serving {served} on {device} at "
          f"http://{args.host}:{server.server_address[1]}")
    # SIGTERM (how orchestrators stop a pod) unwinds serve_forever as
    # Ctrl-C does, closing the listener cleanly
    import signal

    def _term(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _term)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("shutting down")
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
