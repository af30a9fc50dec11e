"""Host loader feeding (LR, HR) patch batches cropped on the device (the port's
copy of the JAX package's ``data/loader.py``).

Per batch: gather the raw tiles on the host (a prefetch thread, the items
decoded by a pool of ``workers`` threads) into a fresh pinned tensor, one
non-blocking host-to-device copy, then the crop and normalization on the
device (``ops/patchify.py``).

Split and order match the JAX loader exactly: a sequential 80/20 train/val
split, train epochs shuffled with ``np.random.default_rng(seed + epoch)``,
a deterministic val order, ``drop_last`` batches, and an epoch counter that
every ``iter()`` advances (so one batch taken with ``next(iter(loader))``
counts as an epoch, as it does in JAX). The random crops' offsets come from
a ``torch.Generator`` seeded with ``seed + 7919 * epoch`` (JAX: a key of
that seed folded with the step); :meth:`DeviceLoader.crop_offsets` is where
they are drawn.

A pinned buffer is never refilled while its copy may be in flight: every
batch takes a new one, and PyTorch's pinned-memory cache hands a block out
again only once the copy that read it has completed.

On a process mesh (``mesh=``, ``parallel/mesh.make_mesh``) each rank yields
its batch shard's contiguous slice of every global batch (JAX
``loader.py:164-167``; the ranks of one shard on the ``model`` axis yield
the same rows) and decodes only its own tiles: the order, the split and
the random crops' offsets are drawn for the global batch from the shared
epoch generator and sliced, so every rank's generator advances alike. A
mesh needs ``drop_last`` and a ``batch_size`` (in tiles) that the batch
shards divide.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from simple_vae_rs_tpu_torch.ops.patchify import crop_offsets, grid_sr_batch, random_sr_crop_batch
from simple_vae_rs_tpu_torch.parallel.mesh import shard_rows
from simple_vae_rs_tpu_torch.serve import resolve_device

Tensor = torch.Tensor
# host sample types torch cannot copy to the card as they are, and the exact
# wider type each crosses in
_WIDEN = {np.dtype(np.uint16): np.int32, np.dtype(np.uint32): np.int64,
          np.dtype(np.float64): np.float32}
_PREFETCH = 2  # host batches the prefetch thread keeps ready


class DeviceLoader:
    """Iterable over (lr, hr) patch batches on ``device``: (B, p/2, p/2, C) and
    (B, p, p, C) float32, B = batch_size tiles, times the patches per tile
    in grid mode.

    With ``timing=True`` each batch records the seconds the consumer waited
    on the prefetch queue and, on the card, CUDA events around the copy and
    the crop; :meth:`timings` sums them. With a process ``mesh`` each batch
    is this rank's slice of the global one."""

    def __init__(self, dataset, batch_size: int, patch_size: int, crop: str = "random",
                 shuffle: bool = False, seed: int = 0, device="cuda", drop_last: bool = True,
                 workers: int = 1, timing: bool = False, mesh=None) -> None:
        if crop not in ("random", "grid"):
            raise ValueError("Crop must be 'grid' or 'random'")
        if workers < 1:
            raise ValueError(f"workers must be >= 1 (got {workers})")
        self.mesh = mesh
        self._rows = slice(None)  # this rank's tiles of a global batch
        if mesh is not None:
            if not mesh.is_process or not drop_last:
                raise ValueError("a loader shards over a process mesh, with drop_last")
            self._rows = shard_rows(mesh, batch_size)
        self.dataset = dataset
        self.batch_size = batch_size
        self.patch_size = patch_size
        self.crop = crop
        self.shuffle = shuffle
        self.seed = seed
        self.device = resolve_device(device)
        self.drop_last = drop_last
        # item decode in threads: zlib, the native LZW codec and numpy
        # release the GIL; pool.map keeps the order, so the batches are the
        # same at any worker count
        self.workers = workers
        self._pool = None
        if workers > 1:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(max_workers=workers,
                                            thread_name_prefix="svrs-decode")
        self.epoch = 0
        self.timing = timing
        self._records: List[Dict] = []
        self._wait = 0.0  # seconds the consumer waited for the current batch

    def close(self) -> None:
        """Shut the decode pool down (idempotent)."""
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None
            self.workers = 1

    def __del__(self) -> None:  # a dropped loader releases its threads
        try:
            self.close()
        except Exception:
            pass

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    # ------------------------------------------------------------- iteration
    def _index_batches(self) -> Sequence[np.ndarray]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(order)
        return [order[i * self.batch_size:(i + 1) * self.batch_size] for i in range(len(self))]

    def _stack(self, arrays: List[np.ndarray]) -> Tensor:
        """One host tensor of the items, pinned when the batch goes to the card."""
        dt = arrays[0].dtype
        dt = np.dtype(_WIDEN.get(dt, dt))
        shape = (len(arrays),) + arrays[0].shape
        if self.device.type != "cuda":
            return torch.from_numpy(np.stack(arrays).astype(dt, copy=False))
        out = torch.empty(shape, dtype=torch.from_numpy(np.empty(0, dt)).dtype, pin_memory=True)
        np.stack(arrays, out=out.numpy(), casting="safe")  # the widening, if any, exact
        return out

    def _gather(self, idxs: np.ndarray) -> Tuple[Tensor, Tensor]:
        if self._pool is not None:
            pairs = list(self._pool.map(lambda i: self.dataset[int(i)], idxs))
        else:
            pairs = [self.dataset[int(i)] for i in idxs]
        return self._stack([p[0] for p in pairs]), self._stack([p[1] for p in pairs])

    def _host_batches(self) -> Iterator[Tuple[Tensor, Tensor]]:
        batches = [idxs[self._rows] for idxs in self._index_batches()]
        q: "queue.Queue" = queue.Queue(maxsize=_PREFETCH)
        stop = threading.Event()
        sentinel = object()

        def worker():
            try:
                for idxs in batches:
                    item = self._gather(idxs)
                    # a bounded put that gives up once the consumer has left
                    # the iteration (``next(iter(loader))`` for one batch), so
                    # the thread never blocks on a full queue forever
                    while not stop.is_set():
                        try:
                            q.put(item, timeout=0.2)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except Exception as exc:  # IO errors reach the consumer
                q.put(exc)
                return
            q.put(sentinel)

        t = threading.Thread(target=worker, daemon=True, name="svrs-loader")
        t.start()
        try:
            while True:
                t0 = time.perf_counter()
                item = q.get()
                self._wait = time.perf_counter() - t0
                if item is sentinel:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()

    def crop_offsets(self, step: int, batch: int, lr_hw: Tuple[int, int],
                     generator: torch.Generator) -> Tuple[Tensor, Tensor]:
        """The random crops' (top, left) of batch ``step`` of this epoch, in
        LR pixels (``ops/patchify.crop_offsets`` from the epoch's generator)."""
        return crop_offsets(batch, lr_hw, self.patch_size, generator)

    def __iter__(self):
        self.epoch += 1
        gen = torch.Generator().manual_seed(self.seed + 7919 * self.epoch)
        cuda = self.device.type == "cuda"
        for step, (lr_host, hr_host) in enumerate(self._host_batches()):
            rec = {"wait_s": self._wait, "step": step}
            if self.timing and cuda:
                rec["events"] = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
                rec["events"][0].record()
            lr = lr_host.to(self.device, non_blocking=True)
            hr = hr_host.to(self.device, non_blocking=True)
            if "events" in rec:
                rec["events"][1].record()
            if self.crop == "grid":
                out = grid_sr_batch(lr, hr, self.patch_size)
            else:
                # drawn for the global batch, this rank's rows taken
                n = lr.shape[0] if self.mesh is None else self.batch_size
                offsets = self.crop_offsets(step, n, tuple(lr.shape[1:3]), gen)
                offsets = tuple(o[self._rows] for o in offsets)
                out = random_sr_crop_batch(lr, hr, self.patch_size, offsets=offsets)
            if "events" in rec:
                rec["events"][2].record()
            if self.timing:
                self._records.append(rec)
            yield out

    def timings(self, reset: bool = True) -> Dict[str, float]:
        """With ``timing=True``: the batches since the last reset, the seconds
        the consumer waited on the prefetch queue (all of them, and those of
        each epoch's first batch, which no prefetch can hide), and on the card
        the copy and crop milliseconds (CUDA events; synchronizes)."""
        recs = self._records
        out = {"batches": len(recs), "wait_s": sum(r["wait_s"] for r in recs),
               "wait_first_s": sum(r["wait_s"] for r in recs if r["step"] == 0),
               "h2d_ms": 0.0, "crop_ms": 0.0}
        if any("events" in r for r in recs):
            torch.cuda.synchronize(self.device)
            for r in recs:
                e0, e1, e2 = r["events"]
                out["h2d_ms"] += e0.elapsed_time(e1)
                out["crop_ms"] += e1.elapsed_time(e2)
        if reset:
            self._records = []
        return out


class _Subset:
    def __init__(self, dataset, indices: Sequence[int]) -> None:
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, i: int):
        return self.dataset[self.indices[i]]


def init_dataloader(dataset: str, batch_size: int = 16, patch_size: int = 256,
                    crop: str = "random", data_root: Optional[str] = None, seed: int = 0,
                    workers: int = 1, device="cuda", timing: bool = False, mesh=None
                    ) -> Tuple[DeviceLoader, DeviceLoader]:
    """(train_loader, val_loader) on ``device`` (the card unless "cpu" is
    asked for), each yielding this rank's slices on a process ``mesh``.
    Dataset names as the reference's ``dataset.py:23-29``:
    "Sen2Venus"/"sen2venus"/"s2v", "Floods"/"floods", plus "synthetic"
    (smooth fields) and "synthetic_hf" (high-frequency scenes)."""
    from simple_vae_rs_tpu_torch.data.datasets import (
        FloodDataset,
        Sen2VenusDataset,
        SyntheticHFDataset,
        SyntheticSRDataset,
    )

    name = dataset.lower()
    if name in ("sen2venus", "s2v"):
        ds = Sen2VenusDataset(root=data_root or "ARM", patch_size=patch_size)
    elif name == "floods":
        ds = FloodDataset(root=data_root or "floods", patch_size=256)
    elif name == "synthetic":
        ds = SyntheticSRDataset(seed=seed)
    elif name == "synthetic_hf":
        ds = SyntheticHFDataset(seed=seed)
    else:
        raise ValueError(f"Unknown dataset: {dataset}")

    train_size = int(0.8 * len(ds))
    train_ds = _Subset(ds, range(train_size))
    val_ds = _Subset(ds, range(train_size, len(ds)))
    train_loader = DeviceLoader(train_ds, batch_size, patch_size, crop=crop, shuffle=True,
                                seed=seed, device=device, workers=workers, timing=timing,
                                mesh=mesh)
    # val keeps the loader's crop mode, unshuffled, with its own seed
    val_loader = DeviceLoader(val_ds, batch_size, patch_size, crop=crop, shuffle=False,
                              seed=seed + 1, device=device, workers=workers, timing=timing,
                              mesh=mesh)
    # batches of a fixed size drop the ragged tail, so a split smaller than
    # one batch would give no batch at all: fail here, with what to change
    for split, ldr, n_items in (("train", train_loader, len(train_ds)),
                                ("val", val_loader, len(val_ds))):
        if len(ldr) == 0:
            raise ValueError(
                f"{split} split has {n_items} tiles — fewer than one "
                f"batch of {batch_size} (static shapes drop the ragged "
                f"tail). Reduce --batch_size or add data."
            )
    return train_loader, val_loader
