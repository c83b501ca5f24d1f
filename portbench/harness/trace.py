"""Read a ``torch.profiler`` trace of the window: device busy time, device
time by kernel, and the idle gaps by what the host was doing.

The profiler records CPU events (the harness's own spans, named
``portbench::...``, the aten ops and the CUDA runtime calls) and device
events (kernels, copies, fills) on one clock. The window is the
``portbench::window`` span.
"""
from __future__ import annotations

import heapq
from collections import defaultdict

WINDOW = "portbench::window"


def _annotation(e) -> bool:
    """Whether a device-side event is a user annotation (a
    ``record_function`` span drawn over the kernels it covers)."""
    flag = getattr(e, "is_user_annotation", None)
    return bool(flag and flag()) or e.name().startswith("portbench::")


def summarize(prof, top: int = 10) -> dict:
    """``busy_s`` (the union of device events inside the window),
    ``window_s``, ``kernels`` (device name -> [count, seconds] of the
    events that start in the window), ``device_ops`` and ``idle_gaps``
    (the ``top`` names with the most seconds, as ``[name, seconds]``)."""
    from torch.autograd import DeviceType

    dev, cpu, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        a, b = e.start_ns(), e.end_ns()
        if e.device_type() == DeviceType.CUDA:
            # a span's shadow on the device timeline is no device work
            if not _annotation(e):
                dev.append((a, b, e.name()))
        else:
            name = e.name()
            if name == WINDOW:
                window = (a, b)
            cpu.append((a, b, name))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW} span")
    w0, w1 = window
    dev = sorted(d for d in dev if w0 <= d[0] < w1)
    kernels = defaultdict(lambda: [0, 0.0])
    merged = []
    for a, b, name in dev:
        k = kernels[name]
        k[0] += 1
        k[1] += (b - a) * 1e-9
        b = min(b, w1)
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    gaps = []
    prev = w0
    for a, b in merged:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1))
    return dict(busy_s=busy * 1e-9, window_s=(w1 - w0) * 1e-9,
                kernels=dict(kernels),
                device_ops=_top({n: s for n, (_, s) in kernels.items()}, top),
                idle_gaps=_top(_by_host(gaps, cpu), top))


def _by_host(gaps: list, cpu: list) -> dict:
    """Gap seconds summed by the innermost host event that covers each
    gap's midpoint (of the events that have not ended, the one that
    started last), or ``host: no event`` where none does. One sweep in
    time order: an event that ended before a midpoint covers no later
    one."""
    cpu = sorted(e for e in cpu if e[2] != WINDOW)
    out = defaultdict(float)
    live, i = [], 0  # max-heap on start: (-start, end, name)
    for a, b in gaps:
        m = (a + b) // 2
        while i < len(cpu) and cpu[i][0] <= m:
            heapq.heappush(live, (-cpu[i][0], cpu[i][1], cpu[i][2]))
            i += 1
        while live and live[0][1] < m:
            heapq.heappop(live)
        out[live[0][2] if live else "host: no event"] += (b - a) * 1e-9
    return out


def _top(d: dict, n: int) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
