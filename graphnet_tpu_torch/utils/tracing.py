"""Named ranges around the port's host work, for ``torch.profiler``.

``span(name)`` is ``torch.profiler.record_function(name)`` while a
profiler session records on the calling thread, and one shared no-op
context otherwise.  The profiler's own state decides, so the ranges show
in any ``torch.profiler`` trace (``Trainer.fit(profile_dir=...)``'s, a
benchmark's) and cost one look at that state and an empty ``with``, under
1 µs, when nothing records.  In a chrome trace they are ``user_annotation`` events on the
clock of the device activities recorded beside them.  No span is open
across a ``yield``, and none touches the device.

Names are ``graphnet.<layer>.<part>`` and never hold ``#``, which trace
readers take as the start of an index.  Each row nests in its first span:

* ``graphnet.trainer.step``: ``.h2d``, ``.forward``, ``.backward``,
  ``.optimizer`` (``Trainer.train_step``; zero_grad before the forward,
  then the gradient sync, clip, step, schedule and averages);
* ``graphnet.loader.batch``: ``.fetch``, ``.collate``
  (``DataLoader``, either route; shown only when batches are built on the
  profiled thread, ``num_workers=0`` and no prefetch, since the
  profiler's state is kept per thread and the worker and prefetch
  threads do not record);
* ``graphnet.deploy.request``: ``.collate``, ``.pad``, ``.h2d``,
  ``.forward``, ``.d2h`` (``DeploymentModule.__call__``; the D2H copy
  waits for the forward).

``benchmark/harness/spans.py`` splits a trace's device idle time by the
innermost of these spans the host was in.
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled


def span(name: str):
    """A profiler range named ``name`` while a session records on this
    thread, else a shared context that does nothing."""
    if _recording():
        return torch.profiler.record_function(name)
    return _OFF
