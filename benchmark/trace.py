"""What the traced run reads: spans around calls into the port's layers,
and a torch.profiler stretch reduced to busy time, idle gaps and the
device operations that took the most time.

Spans are the benchmark's own: wrappers on instance attributes and
forward hooks, installed only in a traced run, each span opened and closed
by ``torch.cuda.synchronize()`` so that it times the device work it
enqueued. They are kept in memory and read when the run ends.
"""
from __future__ import annotations

import collections
import time
from typing import Callable, Dict, List, Optional

import torch


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Spans:
    """Named durations (seconds) of the calls wrapped while ``on``."""

    def __init__(self, device: torch.device):
        self.device = device
        self.on = False
        self.times: Dict[str, List[float]] = collections.defaultdict(list)
        self._handles = []
        self._wrapped = []

    def wrap(self, obj, attr: str, name: str) -> None:
        """Time ``obj.attr(...)`` (a bound method or a module's function)
        as ``name`` by an attribute that shadows it until ``close``."""
        inner = getattr(obj, attr)
        self._wrapped.append((obj, attr, vars(obj).get(attr)))

        def timed(*args, **kwargs):
            if not self.on:
                return inner(*args, **kwargs)
            sync(self.device)
            t0 = time.perf_counter()
            out = inner(*args, **kwargs)
            sync(self.device)
            self.times[name].append(time.perf_counter() - t0)
            return out
        setattr(obj, attr, timed)

    def hook(self, module: torch.nn.Module, name: str) -> None:
        """Time ``module``'s forward as ``name`` by forward hooks."""
        start: List[float] = []

        def pre(mod, args):
            if self.on:
                sync(self.device)
                start.append(time.perf_counter())

        def post(mod, args, out):
            if self.on and start:
                sync(self.device)
                self.times[name].append(time.perf_counter() - start.pop())
        self._handles += [module.register_forward_pre_hook(pre),
                          module.register_forward_hook(post)]

    def total(self, name: str) -> float:
        return sum(self.times.get(name, ()))

    def close(self) -> None:
        """Take the wrappers and hooks away (the times stay)."""
        for obj, attr, own in reversed(self._wrapped):
            if own is None:
                delattr(obj, attr)
            else:
                setattr(obj, attr, own)
        for h in self._handles:
            h.remove()
        self._wrapped, self._handles = [], []


def _split_events(events):
    """(device, host) lists of (start us, end us, name) from the
    profiler's raw events: the device's own activities (kernels, copies
    and sets, not the user annotations the profiler also lists there) and
    the host's operations."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in events:
        item = (e.start_ns() / 1e3, e.end_ns() / 1e3, e.name())
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append(item)
        elif e.device_type() == DeviceType.CPU:
            host.append(item)
    return dev, host


def reduce_events(dev, host, window_s: float) -> Dict[str, object]:
    """A profiled stretch's summary from its device activities ``dev`` and
    host operations ``host`` ((start us, end us, name) each): ``window_s``
    the wall, ``busy_s`` the union of the device's intervals (None when
    there was none), ``device_ops`` [[name, s]] the ten names with the most
    device time, ``idle_gaps`` [[host op, s]] the ten longest gaps between
    device activities, each named by the innermost host operation open at
    its middle."""
    summary = {"window_s": window_s, "busy_s": None, "device_ops": [],
               "idle_gaps": []}
    dev = sorted(dev)
    if not dev:
        return summary
    by_name: Dict[str, float] = collections.defaultdict(float)
    busy, gaps = 0.0, []
    cur_s, cur_e = dev[0][0], dev[0][1]
    for s, e, name in dev:
        by_name[name] += (e - s) / 1e6
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    summary["busy_s"] = busy / 1e6
    summary["device_ops"] = [[n, t] for n, t in sorted(
        by_name.items(), key=lambda kv: -kv[1])[:10]]
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = (s + e) / 2
        open_ops = [h for h in host if h[0] <= mid <= h[1]]
        name = min(open_ops, key=lambda h: h[1] - h[0])[2] if open_ops \
            else "(no host op)"
        summary["idle_gaps"].append([name, (e - s) / 1e6])
    return summary


def profile(fn: Callable[[], object], device: torch.device):
    """Run ``fn()`` once under torch.profiler (CPU and CUDA), ending in a
    synchronise. Returns (fn's result, ``reduce_events``' summary)."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sync(device)
    with tprofile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        sync(device)
        wall = time.perf_counter() - t0
    events = prof.profiler.kineto_results.events()
    return out, reduce_events(*_split_events(events), wall)


def device_info(device: torch.device, count: int) -> Dict[str, object]:
    """The result line's ``device`` key (peak memory read by the caller)."""
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": count}


def power_limit() -> Optional[str]:
    """The card's name and power limit from nvidia-smi, or None."""
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None

