"""Every idle gap of a profiled stretch, put down to the port's span open
over it.

The port's tracer (``diff_vits_tpu_torch.core.trace``), when on under
``torch.profiler``, opens a ``record_function`` range for each of its
spans (names starting ``dvt.``); the profiler lists those ranges among
the host's events, on the clock of the device's activities. A gap between
device activities belongs to the innermost such range open at its middle,
whatever ATen operation the host was in then.
"""
from __future__ import annotations

import collections
from typing import Dict, List, Tuple

OUTSIDE = "(no span)"

Event = Tuple[float, float, str]


def idle_by_span(dev: List[Event], host: List[Event]) -> Dict[str, float]:
    """Idle seconds by span name over every gap between the device
    activities ``dev``, each put down to the innermost (shortest) ``dvt.``
    range of ``host`` open at its middle, or to ``OUTSIDE``. Both lists
    hold (start us, end us, name), as ``trace._split_events`` gives
    them."""
    spans = [h for h in host if h[2].startswith("dvt.")]
    out: Dict[str, float] = collections.defaultdict(float)
    dev = sorted(dev)
    if not dev:
        return {}
    cur_e = dev[0][1]
    for s, e, _ in dev:
        if s > cur_e:
            mid = (cur_e + s) / 2
            open_ = [h for h in spans if h[0] <= mid <= h[1]]
            name = min(open_, key=lambda h: h[1] - h[0])[2] if open_ \
                else OUTSIDE
            out[name] += (s - cur_e) / 1e6
        cur_e = max(cur_e, e)
    return dict(out)
