"""Training steps: ``Trainer`` steps on batches that the port's data layer
cuts on the card from a resident tile pool, in a seeded order;
``scan_steps`` steps a dispatch (``train_multi_step``, one CUDA graph
replay, for 2; the eager ``train_step`` for 1); closed, with at most
:data:`AHEAD` dispatches in flight and no read back until the window ends.
``units`` are steps, each of ``rows`` patches.

Set-up drives the one ``Trainer`` through its first ``checked_steps``
steps with the window's own call and feed; the check compares those steps
with the reference's: each step's loss and each of its terms, Adam's first
moment after the first call, and the parameters' change.
"""

from __future__ import annotations

import functools
import gc
import time
from typing import Dict, List

import numpy as np
import torch

from port_bench import families
from port_bench.harness import check, data, work
from port_bench.loops import check_keys, span, sync, torch_dtype
from port_bench.reference import train as rt

Tensor = torch.Tensor

AHEAD = 2  # dispatches in flight at most: the host stays one call ahead of the card
ORDER_STEPS = 20000  # steps of tile order drawn at set-up; a longer window wraps round


def _leaf_norms(tensors: Dict[str, Tensor]) -> Dict[str, float]:
    names = list(tensors)
    norms = torch.stack([tensors[n].detach().double().norm() for n in names]).cpu()
    return dict(zip(names, norms.tolist()))


class Loop:
    kind = "train"
    KEYS = ("dtype", "scan_steps", "tiles_per_step", "pool_tiles", "lr_tile", "learning_rate",
            "grad_clip_norm", "checked_steps")
    plant = None

    def __init__(self, cfg: dict, traffic: dict, seed: int, device) -> None:
        check_keys(traffic, self.KEYS, "train")
        self.cfg, self.traffic, self.device = cfg, traffic, torch.device(device)
        self.family = families.load(cfg)
        self.seeds = data.sub_seeds(seed)
        self.dtype = traffic["dtype"]
        self.k = int(traffic["scan_steps"])
        self.per_step = int(traffic["tiles_per_step"])
        self.rows = self.per_step * (int(traffic["lr_tile"]) // self.family.lr_patch(cfg)) ** 2
        self.checked = int(traffic["checked_steps"])
        self.lr = float(traffic["learning_rate"])
        self.clip = float(traffic["grad_clip_norm"])
        self.trainer = None
        self.records: Dict[str, object] = {}
        self.setup_parts: Dict[str, float] = {}
        self.next_step = 0

    # ------------------------------------------------------------- data
    def _tiles(self) -> Dict[str, Tensor]:
        return data.make_tiles(int(self.traffic["pool_tiles"]), int(self.traffic["lr_tile"]),
                               self.seeds["tiles"], self.device)

    def _orders(self, steps: int) -> np.ndarray:
        return data.step_orders(self.seeds["order"], int(self.traffic["pool_tiles"]),
                                self.per_step, steps)

    def _weights(self) -> Dict[str, Tensor]:
        return data.make_weights(self.family.param_spec(self.cfg), self.seeds["weights"],
                                 self.device)

    def _batch(self, i: int):
        idx = self.order[i % self.order.shape[0]]
        return self.family.program_batch(self.cfg, self.tiles["lr"].index_select(0, idx),
                                         self.tiles["hr"].index_select(0, idx))

    def _dispatch(self, i: int):
        """Steps i .. i + k - 1 as one call; their summed terms. Off the
        card (tests), k eager steps, as ``train_multi_step`` runs them there."""
        if self.k == 1:
            return self.trainer.train_step(self._batch(i), lr=self.lr)
        batches = [self._batch(i + j) for j in range(self.k)]
        if self.device.type != "cuda":
            self._eager = [self.trainer.train_step(b, lr=self.lr) for b in batches]
            return {"loss": sum(t["loss"] for t in self._eager)}
        stacks = tuple(torch.stack(parts) for parts in zip(*batches))
        return self.trainer.train_multi_step(stacks, lr=self.lr)

    def _step_terms(self, terms) -> List[Dict[str, float]]:
        """Each step's terms of the call just made."""
        if self.k == 1:
            steps = [terms]
        elif self.device.type != "cuda":
            steps = self._eager
        else:
            (graph,) = self.trainer.graphs.values()  # the one graph, just replayed
            steps = graph.step_terms
        return [{n: float(st[n]) for n in self.family.TERMS} for st in steps]

    # ------------------------------------------------------------ program
    def setup(self) -> None:
        from simple_vae_rs_tpu_torch import TrainConfig, Trainer

        t0 = time.perf_counter()
        model = self.family.port_model(self.cfg, torch_dtype(self.dtype), self.device)
        weights = self._weights()
        data.load_into(model, weights)
        tc = TrainConfig(learning_rate=self.lr, grad_clip_norm=self.clip,
                         use_bfloat16=self.dtype == "bfloat16", scan_steps=self.k)
        self.trainer = Trainer(model, tc, device=self.device, seed=self.seeds["trainer"])
        if self.plant is not None:
            self.plant(self)
        self.tiles = self._tiles()
        self.order = torch.as_tensor(self._orders(ORDER_STEPS), device=self.device)
        sync(self.device)
        t1 = time.perf_counter()
        # the checked steps: through the window's own call, on the window's feed
        terms: List[Dict[str, float]] = []
        for i in range(0, self.checked, self.k):
            terms += self._step_terms(self._dispatch(i))
            if i == 0:
                params = self.trainer.params
                self.records["moment"] = _leaf_norms(dict(zip(params, self.trainer.opt.mu)))
        self.records["terms"] = terms
        self.records["change"] = _leaf_norms(
            {n: p.detach() - weights[n] for n, p in self.trainer.params.items()})
        del weights
        self.next_step = self.checked
        sync(self.device)
        self.setup_parts = {"program_s": t1 - t0, "warm_s": time.perf_counter() - t1}

    def window(self, seconds: float) -> Dict[str, object]:
        cuda = self.device.type == "cuda"
        done: List[Tensor] = []
        marks: List = []
        i = self.next_step
        t0 = time.perf_counter()
        end = t0 + seconds
        while time.perf_counter() < end:
            if cuda and len(marks) >= AHEAD:
                marks[-AHEAD].synchronize()
            with span("bench.step"):
                terms = self._dispatch(i)
            done.append(terms["loss"].detach())
            if cuda:
                ev = torch.cuda.Event()
                ev.record()
                marks.append(ev)
            i += self.k
        sync(self.device)
        elapsed = time.perf_counter() - t0
        self.next_step = i
        finite = torch.isfinite(torch.stack(done)).cpu().tolist() if done else []
        steps = len(done) * self.k
        return {"units": steps, "attempted": steps,
                "failed": self.k * sum(1 for ok in finite if not ok), "elapsed_s": elapsed,
                "train_patches_per_s": steps * self.rows / elapsed}

    def work(self) -> Dict[str, float]:
        return work.train_step_work(self.family.conv_sites(self.cfg, self.rows), self.dtype)

    def program_records(self, result: Dict[str, object]) -> Dict[str, object]:
        """The checked steps' records, and the window's steps whose terms
        were not finite (a step that says the wrong thing)."""
        records = dict(self.records, failed_steps=int(result["failed"]))
        self.trainer = self.tiles = self.order = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return records

    # ---------------------------------------------------------- reference
    def reference_records(self, rounding) -> Dict[str, object]:
        """The reference's records of the checked steps, from the same
        weights, tiles, order and noise as the program had."""
        weights = self._weights()
        tiles = self._tiles()
        order = self._orders(self.checked)
        gen = data.generator(self.seeds["trainer"], self.device)
        batches, noises = [], []
        for i in range(self.checked):
            idx = torch.as_tensor(order[i], device=self.device)
            streams = self.family.streams(self.cfg, tiles["lr"].index_select(0, idx),
                                          tiles["hr"].index_select(0, idx))
            batches.append(streams)
            noises.append([torch.randn(s, generator=gen, device=self.device)
                           for s in self.family.noise_shapes(self.cfg, streams[0].shape[0])])
        del tiles
        with rt.tf32_off():
            out = rt.run_steps(self.family.trainable(self.cfg),
                               functools.partial(self.family.loss, self.cfg), weights, batches,
                               noises, self.lr, self.clip, rounding, moment_after=self.k)
        return {"terms": out["terms"], "moment": _leaf_norms(out["moments"]),
                "grad": out["first_grad_norms"],
                "change": _leaf_norms({n: out["params"][n] - weights[n] for n in out["params"]})}

    def compare(self, prog: Dict[str, object], ref: Dict[str, object]) -> Dict[str, float]:
        numbers = check.train_numbers(prog, ref)
        numbers["failed_steps"] = prog.get("failed_steps", 0)
        return numbers

