"""The traced run's device trace: ``torch.profiler`` over the measured
window, kept in memory (no chrome trace is written), reduced to what the
per-layer metrics and the result's ``breakdown`` read."""

from __future__ import annotations

import dataclasses
import time

from port_bench import yardstick

# Names are cut to this many characters in the breakdown (kernel names
# carry their whole template signature).
NAME_CHARS = 160


@dataclasses.dataclass
class Trace:
    """Device operations as (start_us, end_us, name); the traced window's
    bounds in the same clock; host events of the main thread as (start_us,
    end_us, name); the device-side ranges of the host spans
    (``record_function``) as (start_us, end_us, name)."""

    device: list
    host: list
    start_us: float
    stop_us: float
    window_s: float
    annotations: list = dataclasses.field(default_factory=list)

    @property
    def busy_s(self) -> float:
        return yardstick.busy_seconds([(a, b) for a, b, _ in self.device])

    def busy_s_outside(self, span: str) -> float:
        """Busy seconds of the device operations that start in no device
        range of the host span ``span``."""
        ranges = [(a, b) for a, b, name in self.annotations if name == span]
        return yardstick.busy_seconds([(a, b) for a, b, _ in self.device
                                       if not any(lo <= a < hi for lo, hi in ranges)])

    def kernel_seconds(self, match) -> list:
        """Durations, in seconds, of the device operations whose name
        ``match(name)`` accepts."""
        return [(b - a) * 1e-6 for a, b, name in self.device if match(name)]

    def breakdown(self) -> dict:
        ops = yardstick.top(((n[:NAME_CHARS], (b - a) * 1e-6) for a, b, n in self.device))
        gaps = yardstick.idle_gaps([(a, b) for a, b, _ in self.device], self.start_us,
                                   self.stop_us)
        return {"device_ops": [list(kv) for kv in ops],
                "idle_gaps": [list(kv) for kv in yardstick.top(self._attribute(gaps))]}

    def _attribute(self, gaps):
        """(host event name, gap seconds) for every gap: the innermost host
        event open at the gap's middle, a harness span (``port_bench.*``) or
        the program's own operation under it ("host idle" where none is)."""
        events = sorted(self.host)
        stack, i, out = [], 0, []
        for a, b in gaps:
            mid = 0.5 * (a + b)
            while i < len(events) and events[i][0] <= mid:
                while stack and stack[-1][1] <= events[i][0]:
                    stack.pop()
                stack.append(events[i])
                i += 1
            while stack and stack[-1][1] <= mid:
                stack.pop()
            name = stack[-1][2][:NAME_CHARS] if stack else "host idle"
            out.append((name, (b - a) * 1e-6))
        return out


class DeviceTracer:
    """``torch.profiler`` on the CPU and the card while entered."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)

    def read(self) -> Trace:
        from torch.autograd import DeviceType

        device, host, annotations, threads = [], [], [], {}
        t_min, t_max = float("inf"), float("-inf")
        for ev in self._prof.events():
            a, b = ev.time_range.start, ev.time_range.end
            if ev.device_type == DeviceType.CUDA:
                # a host span's mirror on the device is no device work
                if getattr(ev, "is_user_annotation", False):
                    annotations.append((a, b, ev.name))
                else:
                    device.append((a, b, ev.name))
            else:
                host.append((a, b, ev.name, ev.thread))
                threads[ev.thread] = threads.get(ev.thread, 0) + 1
                t_min, t_max = min(t_min, a), max(t_max, b)
        main = max(threads, key=threads.get) if threads else None
        host = [(a, b, n) for a, b, n, t in host if t == main]
        if device:
            t_min = min(t_min, min(a for a, _, _ in device))
            t_max = max(t_max, max(b for _, b, _ in device))
        return Trace(device=device, host=host, start_us=t_min, stop_us=t_max,
                     window_s=self.window_s, annotations=annotations)
