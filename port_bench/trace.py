"""The profiler pass of a traced run, and what is read from it.

``profile(step, n, sync)`` runs ``n`` iterations under ``torch.profiler``
(CPU and CUDA activities, input shapes) inside one marked span, with the
device idle at its start and synchronised at its end. ``Trace`` gives the
device's busy time (the union of the intervals of its kernels, copies and
fills within the span), the device time of the kernels the profiler links
to a named op (its own and those of the ops it calls), and the
``breakdown``: the device operations that took most time and the idle
gaps by what the host was doing at their start.
"""

from __future__ import annotations

import heapq
from collections import defaultdict

WINDOW = "port_bench.traced_window"
_TOP = 10


def profile(step, n: int, sync) -> "Trace":
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as torch_profile

    sync()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA],
                       record_shapes=True) as prof:
        with record_function(WINDOW):
            for _ in range(n):
                step()
            sync()
    return Trace(prof.events())


def _on_device(evt) -> bool:
    return str(evt.device_type).rsplit(".", 1)[-1] != "CPU"


class Trace:
    def __init__(self, events):
        self.events = list(events)
        marks = [e for e in self.events if e.name == WINDOW and
                 not _on_device(e)]
        if len(marks) != 1:
            raise RuntimeError(f"{len(marks)} traced windows in the trace")
        self.start = marks[0].time_range.start
        self.end = marks[0].time_range.end
        self.device = []
        for e in self.events:
            # a span of the host's (this pass's mark) projected onto the
            # device's timeline is no work of the device's
            if _on_device(e) and not (e.name == WINDOW or getattr(
                    e, "is_user_annotation", False)):
                a = max(e.time_range.start, self.start)
                b = min(e.time_range.end, self.end)
                if b > a:
                    self.device.append((a, b, e.name))
        self.device.sort()
        self.cpu = sorted((e for e in self.events
                           if not _on_device(e) and e.name != WINDOW),
                          key=lambda e: e.time_range.start)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-6

    def busy_intervals(self):
        merged = []
        for a, b, _ in self.device:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def ops(self, match):
        """The outermost CPU events whose name satisfies ``match``, each
        with the seconds of device work the profiler links to it."""
        found = []
        for e in self.cpu:
            if not match(e.name):
                continue
            parent = e.cpu_parent
            while parent is not None and not match(parent.name):
                parent = parent.cpu_parent
            if parent is None:
                found.append((e, e.device_time_total * 1e-6))
        return found

    def breakdown(self) -> dict:
        by_op = defaultdict(float)
        for a, b, name in self.device:
            by_op[name] += (b - a) * 1e-6
        return {"device_ops": _top(by_op), "idle_gaps": _top(self._gaps())}

    def _gaps(self):
        """Idle seconds by the innermost host op running at each gap's
        start (on any thread), "host outside any op" where none."""
        edges, last = [], self.start
        for a, b in self.busy_intervals():
            if a > last:
                edges.append((last, a))
            last = max(last, b)
        if self.end > last:
            edges.append((last, self.end))
        out = defaultdict(float)
        stacks = defaultdict(list)  # thread -> open events, innermost last
        i = 0
        for a, b in edges:
            while i < len(self.cpu) and self.cpu[i].time_range.start <= a:
                e = self.cpu[i]
                stack = stacks[e.thread]
                while stack and stack[-1].time_range.end <= e.time_range.start:
                    stack.pop()
                stack.append(e)
                i += 1
            best = None
            for stack in stacks.values():
                while stack and stack[-1].time_range.end < a:
                    stack.pop()
                if stack and (best is None or stack[-1].time_range.start >
                              best.time_range.start):
                    best = stack[-1]
            out[best.name if best is not None else "host outside any op"] += \
                (b - a) * 1e-6
        return out


def _top(totals: dict) -> list:
    return [[name[:160], secs] for name, secs in
            heapq.nlargest(_TOP, totals.items(), key=lambda kv: kv[1])]
