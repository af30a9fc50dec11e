"""The program's own spans in a ``torch.profiler`` trace.

    with span("svrs.uq.prior"):
        ...

:func:`span` is ``torch.profiler.record_function(name)`` while a
``torch.profiler`` records, and one shared no-op context otherwise: a span
costs a module-flag test when nothing records (an ungated
``record_function`` costs a dispatcher call each time). Spans are on
exactly where a profiler already records, such as ``TrainConfig.profile_dir``'s
epoch; there is no switch of their own. They land in the profiler's Chrome
trace as ``user_annotation`` events, on the profiler's clock beside the
card's kernels, so each kernel (through its launch's ``correlation``) and
each idle gap of the card can be put down to the span open on the thread
that launched it.

Every name starts with ``svrs.``. A request's or a step's spans nest inside
its root (``svrs.uq.request``, ``svrs.step``) on the thread that called it;
on the card the backward runs on autograd's device thread, and its spans
(``svrs.step.input_grad``, ``svrs.step.weight_grad``) belong to the step
whose ``svrs.step.backward`` encloses them in time.
"""

from __future__ import annotations

import contextlib

from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()  # reentrant and stateless: one serves every site


def span(name: str):
    """A context that records ``name`` in the running profiler's trace, or
    does nothing while no profiler records."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(name)
    return _OFF
