"""The cell's loop: what the window drives, timed on the host clock.

``Batches`` is an offline pass (``batches`` mixes): the test set in
whole batches through ``CompiledModel.run``, ``in_flight`` batches
enqueued ahead of the host, each one's probabilities copied back on a
stream of their own while the next batch runs.  It keeps every answer
for the correctness check and counts what it served.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from .trace import span


class Batches:
    def __init__(self, model, images: torch.Tensor, mix: dict):
        self.model = model
        self.images = images
        self.bs = mix["batch"]
        self.n = images.shape[0] // self.bs
        self.depth = mix["in_flight"]
        self.cuda = images.device.type == "cuda"
        self.stream = torch.cuda.Stream(images.device) if self.cuda else None
        self.next = 0
        self.answers: list[tuple[int, np.ndarray]] = []

    def _issue(self):
        i = self.next % self.n
        self.next += 1
        with span("run"):
            out = self.model.run(self.images[i * self.bs:(i + 1) * self.bs])
        if not self.cuda:
            return i, out, None
        ready = torch.cuda.Event()
        ready.record()
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        with torch.cuda.stream(self.stream):
            self.stream.wait_event(ready)
            host.copy_(out, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        return i, (host, out), done

    def _finish(self, item) -> None:
        i, out, done = item
        with span("copy_back"):
            if done is not None:
                done.synchronize()
                out = out[0]
            self.answers.append((i, out.numpy().copy()))

    def run(self, deadline: float | None = None, units: int = 0) -> dict:
        """Serve batches until ``deadline`` (host clock) or ``units``
        batches; returns the images whose answers reached the host by the
        deadline (the first batch's at least) and the seconds they took.
        Batches still in flight at the close are finished and kept (late,
        not wrong)."""
        queue = collections.deque()
        t0 = time.perf_counter()
        t_last, images, issued = t0, 0, 0
        while True:
            if units and issued == units:
                break
            queue.append(self._issue())
            issued += 1
            if len(queue) < self.depth:
                continue
            self._finish(queue.popleft())
            now = time.perf_counter()
            if deadline is None or now <= deadline or not images:
                images += self.bs
                t_last = now
            if deadline is not None and now >= deadline:
                break
        while queue:
            self._finish(queue.popleft())
            if deadline is None:
                images += self.bs
                t_last = time.perf_counter()
        return {"images": images, "seconds": t_last - t0,
                "attempted": issued * self.bs, "failed": 0,
                "units": issued}

    def warm(self) -> None:
        self.run(units=self.n)
        self.answers.clear()

