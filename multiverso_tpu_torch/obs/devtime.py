"""Device time and device-side counts read without waiting for the device.

* :class:`DeviceTime`: the device time of a section that runs again and
  again on one thread, by pairs of CUDA events harvested once the device
  has passed them (word2vec's transaction, ``SERVER_TRANSACT_DEVICE``; the
  language model's sections).
* :class:`DeviceSection`: a named section of a differentiable computation:
  the host time of its forward (a ``dashboard.monitor`` of the name) and,
  on CUDA, the device time of its forward and of its backward (``<name>
  _DEVICE``, one pair each), the backward's through identity marks on the
  section's input and output.
* :class:`DeviceReadout`: a small device tensor (a step's counts) copied to
  pinned host memory without waiting, handed to a callback once the copy
  has landed.

None of them synchronises the device on the hot path; ``flush`` waits for
what is still pending, once, at the end of a run.
"""

from __future__ import annotations

from collections import deque
from contextlib import contextmanager
from typing import Callable, Iterator, Optional

import torch

from multiverso_tpu_torch.dashboard import Dashboard, monitor, observe


class DeviceTime:
    """The device time of a section that runs again and again on one
    thread, by a pair of CUDA events recorded on the current stream around
    each run. It never waits for the device: each :meth:`begin` first
    records, into the ``name`` monitor and histogram, the earlier pairs
    whose end event the device has passed (``query()``), oldest first, as
    the stream completes them. ``event`` makes an event (a timing
    ``torch.cuda.Event`` by default)."""

    def __init__(self, name: str,
                 event: Optional[Callable[[], object]] = None) -> None:
        self.name = name
        self._event = event or (lambda: torch.cuda.Event(enable_timing=True))
        self._pending: deque = deque()

    def harvest(self) -> None:
        """Record every finished pair, oldest first; leave the rest."""
        while self._pending and self._pending[0][1].query():
            self._record(*self._pending.popleft())

    def _record(self, start, end) -> None:
        seconds = start.elapsed_time(end) / 1e3
        Dashboard.get(self.name).observe(seconds)
        observe(self.name, seconds)

    def begin(self):
        """Harvest, then record and return the start event of a run."""
        self.harvest()
        start = self._event()
        start.record()
        return start

    def end(self, start) -> None:
        """Record the run's end event; the pair waits for a later harvest."""
        end = self._event()
        end.record()
        self._pending.append((start, end))

    def flush(self) -> None:
        """Wait for every pending pair and record it (end of a run)."""
        while self._pending:
            start, end = self._pending.popleft()
            end.synchronize()
            self._record(start, end)


class _Mark(torch.autograd.Function):
    """Identity whose backward calls ``hook`` when the gradient passes."""

    @staticmethod
    def forward(ctx, x, hook):
        ctx.hook = hook
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        ctx.hook()
        return grad, None


class DeviceSection:
    """A named section of a forward pass and its backward.

    ``with section():`` around the forward code times its host issue (the
    ``name`` monitor, a profiler range under ``profile_annotations``) and,
    on CUDA, its device time (``name + "_DEVICE"``). :meth:`enter` and
    :meth:`leave` mark the section's input and output tensors: when the
    backward reaches the output's mark a device pair starts, and when it
    leaves through the input's mark the pair ends, so ``<name>_DEVICE``
    also holds the backward's device time (the autograd engine runs a
    section's backward nodes together, newest first). Marks on a tensor
    that needs no gradient do nothing. Not shared between threads."""

    def __init__(self, name: str, device: torch.device) -> None:
        self.name = name
        self.timer = (DeviceTime(name + "_DEVICE")
                      if torch.device(device).type == "cuda" else None)
        self._backward: list = []

    @contextmanager
    def __call__(self) -> Iterator[None]:
        with monitor(self.name):
            start = self.timer.begin() if self.timer is not None else None
            yield
            if start is not None:
                self.timer.end(start)

    def _open(self) -> None:
        self._backward.append(self.timer.begin())

    def _close(self) -> None:
        if self._backward:
            self.timer.end(self._backward.pop())

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        if self.timer is None or not x.requires_grad:
            return x
        return _Mark.apply(x, self._close)

    def leave(self, y: torch.Tensor) -> torch.Tensor:
        if self.timer is None or not y.requires_grad:
            return y
        return _Mark.apply(y, self._open)

    def flush(self) -> None:
        self._backward.clear()
        if self.timer is not None:
            self.timer.flush()


class DeviceReadout:
    """Small device tensors read to the host without waiting: each
    :meth:`submit` starts a copy into pinned memory behind an event; the
    callback ``fn(host_tensor)`` gets each one, oldest first, at a later
    :meth:`harvest` once the device has passed the event. A CPU tensor is
    handed over at once."""

    def __init__(self, fn: Callable[[torch.Tensor], None]) -> None:
        self.fn = fn
        self._pending: deque = deque()

    def submit(self, t: torch.Tensor) -> None:
        self.harvest()
        if t.device.type != "cuda":
            self.fn(t.detach().clone())
            return
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t.detach(), non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        self._pending.append((done, host))

    def harvest(self) -> None:
        while self._pending and self._pending[0][0].query():
            self.fn(self._pending.popleft()[1])

    def flush(self) -> None:
        while self._pending:
            done, host = self._pending.popleft()
            done.synchronize()
            self.fn(host)
