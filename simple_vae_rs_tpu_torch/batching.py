"""Dynamic request micro-batching for the model server.

A ``super_resolve`` request costs the launches of a whole generation
whether it carries 1 window or 64: at small batches the card waits on the
host's launches (PERF.md calls B=16 host-bound). So N concurrent clients
served one by one pay N generations. The :class:`MicroBatcher` merges
requests that arrive within a short window into ONE dispatch:

- requests are grouped by ``(normalize flag, window shape)``, one dispatch
  per group, and concatenated along the batch axis;
- the merged batch is padded up to a power-of-two **bucket** by repeating
  its last row, so the set of batch shapes the kernels see stays
  ``log2(max_batch)`` large (the padding rows are dropped before callers
  see them);
- the dispatch's result is copied to the host once (``tiling.to_host``:
  the resolver returns a tensor on the card) and split; callers block on
  an event and receive their slice, or the dispatch's exception.

The batcher holds no device state and never reorders rows within a group.
The server turns it on with ``--dynamic_batch_ms`` (``server.py``).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from simple_vae_rs_tpu_torch.tiling import to_host

__all__ = ["MicroBatcher", "bucket_size"]


def bucket_size(n: int) -> int:
    """Smallest power of two >= ``n`` — the compile-shape bucket. (The
    ``max_batch`` cap applies to *collection*; a merged batch always pads
    to its own pow2 bucket so the compile set stays logarithmic.)"""
    if n < 1:
        raise ValueError(f"bucket_size needs n >= 1 (got {n})")
    return 1 << (n - 1).bit_length()


class _Item:
    __slots__ = ("lr", "normalize", "event", "out", "err")

    def __init__(self, lr: np.ndarray, normalize: Optional[bool]) -> None:
        self.lr = lr
        self.normalize = normalize
        self.event = threading.Event()
        self.out: Optional[np.ndarray] = None
        self.err: Optional[BaseException] = None


class MicroBatcher:
    """Coalesce concurrent SR requests into bucketed device dispatches.

    Parameters
    ----------
    fn:
        ``fn(lr_batch, normalize)`` — the locked resolver call, returning
        an array or a tensor on any device. Runs on the batcher thread only.
    max_batch:
        Stop collecting once this many rows are queued for one dispatch.
    max_delay_ms:
        How long the first request in a batch waits for company. The
        clock starts at the first arrival, so an idle server adds at
        most this much latency to a lone request.
    follow_ms:
        Inter-arrival cutoff (default ``min(max_delay_ms / 8, 2.0)`` —
        HTTP handler threads re-post within microseconds, so a couple
        of milliseconds is generous jitter headroom). The first
        companion is awaited for the full window (that wait is the
        speculative cost of batching), but once ANY companion has
        arrived — evidence the load is concurrent — collection stops as
        soon as no further request lands within this gap. Concurrent
        clients post within microseconds of each other, so a
        synchronized burst dispatches after ~one follow gap instead of
        sitting out the whole window while every would-be companion is
        already blocked on *this* batch; ``max_delay_ms`` can then be
        sized generously (it bounds added latency for lone requests)
        without capping loaded throughput at ``1/window``.
    """

    def __init__(self, fn: Callable[[np.ndarray, Optional[bool]], np.ndarray],
                 max_batch: int = 64, max_delay_ms: float = 5.0,
                 follow_ms: Optional[float] = None) -> None:
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1 (got {max_batch})")
        self._fn = fn
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_ms) / 1e3
        if follow_ms is None:
            follow_ms = min(max_delay_ms / 8.0, 2.0)
        self.follow_s = min(float(follow_ms) / 1e3, self.max_delay_s)
        self._q: "queue.Queue[Optional[_Item]]" = queue.Queue()
        self._closed = False
        # telemetry (read by the server's /metrics)
        self.requests = 0
        self.rows = 0
        self.dispatches = 0
        self.padded_rows = 0
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="svrs-microbatcher")
        self._thread.start()

    # ---------------------------------------------------------------- client
    def submit(self, lr: np.ndarray,
               normalize: Optional[bool] = None) -> np.ndarray:
        """Block until ``lr``'s rows come back from a (shared) dispatch."""
        if self._closed:
            raise RuntimeError("MicroBatcher is closed")
        lr = np.asarray(lr, np.float32)
        if lr.ndim == 3:
            lr = lr[None]
        if lr.ndim != 4 or lr.shape[0] < 1:
            raise ValueError(
                f"expected a (B, h, w, C) LR batch, got {lr.shape}"
            )
        item = _Item(lr, normalize)
        self._q.put(item)
        # bounded wait: if close() raced with this submit (worker consumed
        # its sentinel and drained between our _closed check and the put),
        # nothing will ever complete the item — detect the dead worker
        # instead of blocking the handler thread forever
        while not item.event.wait(timeout=1.0):
            if not self._thread.is_alive():
                raise RuntimeError("MicroBatcher closed")
        if item.err is not None:
            raise item.err
        assert item.out is not None
        return item.out

    def close(self) -> None:
        """Stop the worker; pending items fail with RuntimeError."""
        if self._closed:
            return
        self._closed = True
        self._q.put(None)
        self._thread.join(timeout=5.0)
        if not self._thread.is_alive():
            self._drain_failed()  # items that landed after the worker left

    # ---------------------------------------------------------------- worker
    def _collect(self, first: _Item) -> Tuple[List[_Item], bool]:
        """First item + companions: full window until the first one
        arrives, then the follow gap between arrivals (see class doc)."""
        import time

        batch = [first]
        rows = int(first.lr.shape[0])
        deadline = time.monotonic() + self.max_delay_s
        while rows < self.max_batch:
            timeout = deadline - time.monotonic()
            if len(batch) > 1:
                timeout = min(timeout, self.follow_s)
            if timeout <= 0:
                break
            try:
                nxt = self._q.get(timeout=timeout)
            except queue.Empty:
                break
            if nxt is None:
                return batch, True
            batch.append(nxt)
            rows += int(nxt.lr.shape[0])
        return batch, False

    def _dispatch_group(self, items: List[_Item]) -> None:
        lr = np.concatenate([it.lr for it in items], axis=0)
        n = int(lr.shape[0])
        padded = bucket_size(n)
        if padded > n:
            lr = np.concatenate(
                [lr, np.repeat(lr[-1:], padded - n, axis=0)], axis=0
            )
        try:
            out = to_host(self._fn(lr, items[0].normalize))
        except BaseException as e:  # noqa: BLE001 - forwarded to callers
            for it in items:
                it.err = e
                it.event.set()
            return
        self.dispatches += 1
        self.rows += n
        self.padded_rows += padded - n
        off = 0
        for it in items:
            b = int(it.lr.shape[0])
            it.out = out[off:off + b]
            off += b
            it.event.set()

    def _worker(self) -> None:
        while True:
            first = self._q.get()
            if first is None:
                break
            batch, stopping = self._collect(first)
            self.requests += len(batch)
            # one dispatch per (normalize, window-shape) group, arrival
            # order preserved within each group
            groups: Dict[Tuple[Any, ...], List[_Item]] = {}
            for it in batch:
                groups.setdefault(
                    (it.normalize, it.lr.shape[1:]), []
                ).append(it)
            for items in groups.values():
                self._dispatch_group(items)
            if stopping:
                break
        self._drain_failed()

    def _drain_failed(self) -> None:
        """Fail anything still queued (close() raced with submitters)."""
        while True:
            try:
                it = self._q.get_nowait()
            except queue.Empty:
                return
            if it is not None:
                it.err = RuntimeError("MicroBatcher closed")
                it.event.set()

    # ------------------------------------------------------------- telemetry
    def render_metrics(self) -> str:
        """Prometheus lines for the server's /metrics page."""
        pairs = (
            ("svrs_batcher_requests_total", self.requests),
            ("svrs_batcher_rows_total", self.rows),
            ("svrs_batcher_dispatches_total", self.dispatches),
            ("svrs_batcher_padded_rows_total", self.padded_rows),
        )
        lines = []
        for name, val in pairs:
            lines.append(f"# TYPE {name} counter")
            lines.append(f"{name} {val}")
        return "\n".join(lines) + "\n"
