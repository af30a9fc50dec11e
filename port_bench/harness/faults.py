"""Faults planted in the program under test, for the tests and readings
that show the check catches them: each is a function of the loop, called
once the program object exists and before anything runs on it."""

from __future__ import annotations

from typing import Callable, Dict


def unchanged(loop) -> None:
    """Every optimizer step returns the state unchanged (eager and captured)."""
    loop.trainer.opt.step = lambda *args, **kwargs: None


def half_batch(loop) -> None:
    """Each step trains on the first half of its rows, the mean taken over them."""
    tr = loop.trainer
    whole = tr._batch
    tr._batch = lambda batch: tuple(t[: t.shape[0] // 2] for t in whole(batch))


def half_draws(loop) -> None:
    """A request's maps come from half its draws."""
    res = loop.resolver
    whole = res.uncertainty
    res.uncertainty = lambda y, samples=32, **kw: whole(y, samples=samples // 2, **kw)


def altered(loop) -> None:
    """One value of each mean map is off by 0.01 where the request makes it."""
    res = loop.resolver
    whole = res.uncertainty

    def uncertainty(y, **kw):
        out = dict(whole(y, **kw))
        mean = out["mean"].clone()
        mean.view(-1)[0] += 0.01
        out["mean"] = mean
        return out

    res.uncertainty = uncertainty


FAULTS: Dict[str, Callable] = {"unchanged": unchanged, "half_batch": half_batch,
                               "half_draws": half_draws, "altered": altered}
