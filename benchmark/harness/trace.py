"""The device trace of a window: ``torch.profiler`` with CUDA activity.

:func:`device_events` lists every kernel, copy and set on any stream as
``(name, start µs, end µs)``. :func:`union_s` is the length of their
union (the arithmetic of ``tools/torch_port/profile_step.py::_union_ms``,
copied): the device's busy time, whatever the number of streams;
:func:`span_s` the stretch from the first operation to the last.
"""

from __future__ import annotations

from collections import defaultdict


def profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA])


def device_events(prof) -> list:
    from torch.autograd import DeviceType
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]


def union_s(events) -> float:
    """The length of the union of the events' intervals, in seconds."""
    total, end = 0.0, None
    for a, b in sorted((s, e) for _, s, e in events):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e6


def span_s(events) -> float:
    """From the first operation's start to the last one's end, in
    seconds: the window as the device saw it, whatever the profiler
    adds on the host before the first step and after the last."""
    return (max(e for _, _, e in events) - min(s for _, s, _ in events)) / 1e6


def by_name_s(events) -> dict:
    """Device seconds and calls by name: ``{name: (seconds, calls)}``."""
    out = defaultdict(lambda: [0.0, 0])
    for name, s, e in events:
        out[name][0] += (e - s) / 1e6
        out[name][1] += 1
    return {k: tuple(v) for k, v in out.items()}


def idle_gaps_s(events) -> dict:
    """Idle time between the device's busy stretches, summed by the
    operation the device ran next: ``{"before <name>": seconds}``."""
    gaps = defaultdict(float)
    end = None
    for s, e, name in sorted((s, e, n) for n, s, e in events):
        if end is not None and s > end:
            gaps[f"before {name[:80]}"] += (s - end) / 1e6
        end = e if end is None else max(end, e)
    return dict(gaps)


def breakdown(events, top: int = 10) -> dict:
    ops = sorted(((k[:120], v[0]) for k, v in by_name_s(events).items()),
                 key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle_gaps_s(events).items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps]}
