"""N-draw uncertainty requests: one client's closed loop of
``SuperResolver.uncertainty`` calls, each on one LR window from a pool cut
from the tiles, with a seed of its own for its draws; a request ends when
its mean and std maps are on the host. ``units`` are requests.

The served weights are drawn with BatchNorm's affine and running
statistics too, the statistics then settled on one training batch of the
reference (at init statistics the draws hardly differ, and no check could
see half of them missing). The check compares a sample of the window's
requests, drawn from the seed as they complete (a reservoir, so only the
sampled requests' maps are kept), with the reference's maps.
"""

from __future__ import annotations

import functools
import gc
import statistics
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from port_bench import families
from port_bench.harness import check, data, work
from port_bench.loops import check_keys, span, sync, torch_dtype
from port_bench.reference import models
from port_bench.reference import train as rt

Tensor = torch.Tensor

SETTLE_TILES = 4  # the tiles whose pairs settle BatchNorm's running statistics
WARM_REQUESTS = 3  # set-up's requests: every shape of one request, before the window
PLAN_REQUESTS = 20000  # requests planned at set-up; a longer window wraps round


def p95(values: List[float]) -> float:
    """The 95th percentile of all ``values`` (linear between the two
    nearest ranks, ``statistics.quantiles``' inclusive method)."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=20, method="inclusive")[18]


class Loop:
    kind = "uq"
    KEYS = ("dtype", "samples", "pool_tiles", "lr_tile", "checked_requests")
    plant = None

    def __init__(self, cfg: dict, traffic: dict, seed: int, device) -> None:
        check_keys(traffic, self.KEYS, "requests")
        self.cfg, self.traffic, self.device = cfg, traffic, torch.device(device)
        self.family = families.load(cfg)
        self.seeds = data.sub_seeds(seed)
        self.dtype = traffic["dtype"]
        self.samples = int(traffic["samples"])
        self.patch = self.family.lr_patch(cfg)
        windows = int(traffic["pool_tiles"]) * (int(traffic["lr_tile"]) // self.patch) ** 2
        self.plan = data.request_plan(self.seeds["requests"], windows, PLAN_REQUESTS)
        self.n_checked = int(traffic["checked_requests"])
        # the requests the check compares: set-up's first ones until a window has run
        self.checked = list(range(WARM_REQUESTS, WARM_REQUESTS + self.n_checked))
        self.resolver = None
        self.weights: Optional[Dict[str, Tensor]] = None  # the served weights, on the host
        self.outputs: Dict[int, tuple] = {}
        self.setup_parts: Dict[str, float] = {}
        self.next_request = 0

    def _tiles(self) -> Dict[str, Tensor]:
        return data.make_tiles(int(self.traffic["pool_tiles"]), int(self.traffic["lr_tile"]),
                               self.seeds["tiles"], self.device)

    def _weights(self, tiles: Dict[str, Tensor]) -> Dict[str, Tensor]:
        """The served weights: drawn, then BatchNorm's running statistics
        settled on the first :data:`SETTLE_TILES` tiles' pairs."""
        weights = data.make_weights(self.family.param_spec(self.cfg), self.seeds["weights"],
                                    self.device, random_bn=True)
        streams = self.family.streams(self.cfg, tiles["lr"][:SETTLE_TILES],
                                      tiles["hr"][:SETTLE_TILES])
        gen = data.generator(self.seeds["settle"], self.device)
        noise = [torch.randn(s, generator=gen, device=self.device)
                 for s in self.family.noise_shapes(self.cfg, streams[0].shape[0])]
        data.settle_batch_norm(functools.partial(self.family.loss, self.cfg), weights, streams,
                               noise)
        return weights

    def _served(self) -> Dict[str, Tensor]:
        """The served weights, on the card (a copy on the host is kept for
        the reference), and the pool of raw LR windows the requests are cut
        from, on the host: requests arrive from the host."""
        tiles = self._tiles()
        weights = self._weights(tiles)
        self.weights = {k: v.cpu() for k, v in weights.items()}
        self.pool = rt.grid_patches(tiles["lr"], self.patch).cpu()
        return weights

    def setup(self) -> None:
        from simple_vae_rs_tpu_torch import SuperResolver

        t0 = time.perf_counter()
        weights = self._served()
        model = self.family.port_model(self.cfg, torch_dtype(self.dtype), self.device)
        data.load_into(model, weights)
        del weights
        self.resolver = SuperResolver(model, device=self.device)
        if self.plant is not None:
            self.plant(self)
        sync(self.device)
        t1 = time.perf_counter()
        for _ in range(WARM_REQUESTS):
            self._request(self.next_request)
            self.next_request += 1
        sync(self.device)
        self.setup_parts = {"program_s": t1 - t0, "warm_s": time.perf_counter() - t1}

    def _request(self, i: int):
        j = i % len(self.plan["window"])
        w = self.plan["window"][j]
        out = self.resolver.uncertainty(self.pool[w:w + 1], samples=self.samples,
                                        seed=self.plan["seed"][j])
        with span("bench.to_host"):
            return out["mean"].cpu(), out["std"].cpu()

    def window(self, seconds: float) -> Dict[str, object]:
        lat: List[float] = []
        failed = 0
        slots: List[int] = []  # the reservoir: a uniform sample of the window's requests
        self.outputs = {}
        rng = np.random.default_rng(self.seeds["sample"])
        i = self.next_request
        t0 = time.perf_counter()
        end = t0 + seconds
        while time.perf_counter() < end:
            s = time.perf_counter()
            try:
                with span("bench.request"):
                    mean, std = self._request(i)
                ok = bool(torch.isfinite(mean).all() and torch.isfinite(std).all())
            except RuntimeError as e:  # a request that raises has failed; the loop goes on
                print(f"request {i} failed: {e}", flush=True)
                ok, mean, std = False, None, None
            lat.append(time.perf_counter() - s)
            failed += 0 if ok else 1
            seen = len(lat) - 1
            slot = seen if seen < self.n_checked else int(rng.integers(0, seen + 1))
            if slot < self.n_checked:
                if slot < len(slots):
                    self.outputs.pop(slots[slot], None)
                    slots[slot] = i
                else:
                    slots.append(i)
                if ok:
                    self.outputs[i] = (mean, std)
            i += 1
        elapsed = time.perf_counter() - t0
        self.checked = sorted(slots)
        self.next_request = i
        return {"units": len(lat), "attempted": len(lat), "failed": failed,
                "elapsed_s": elapsed, "uq_requests_per_s": len(lat) / elapsed,
                "uq_p95_ms": 1e3 * p95(lat) if lat else float("nan"),
                "uq_median_ms": 1e3 * statistics.median(lat) if lat else float("nan")}

    def work(self) -> Dict[str, float]:
        sites = (self.family.conv_sites(self.cfg, 1, "prior")
                 + self.family.conv_sites(self.cfg, self.samples, "decode"))
        return work.forward_work(sites, self.dtype)

    def program_records(self, result: Dict[str, object]) -> Dict[int, tuple]:
        """The sampled requests' maps (a request that failed is missing)."""
        records, self.outputs = self.outputs, {}
        self.resolver = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return records

    def reference_records(self, rounding) -> Dict[int, tuple]:
        """The reference's mean and std maps (HWC, on the host) of the
        checked requests, from the same weights, windows and noise."""
        if self.weights is None:  # a control: no program was set up
            self._served()
        weights = {k: v.to(self.device) for k, v in self.weights.items()}
        windows = self.pool.to(self.device)
        out = {}
        with rt.tf32_off():
            for i in self.checked:
                j = i % len(self.plan["window"])
                w = self.plan["window"][j]
                y = rt.normalize(windows[w:w + 1])
                gen = data.generator(self.plan["seed"][j], self.device)
                hwc = models.nhwc(self.family.draws(self.cfg, weights, y, gen, self.samples,
                                                   rounding))
                out[i] = (hwc.mean(0).cpu(), hwc.std(0, correction=0).cpu())
        return out

    def compare(self, prog: Dict[int, tuple], ref: Dict[int, tuple]) -> Dict[str, float]:
        return check.request_numbers(prog, ref)
