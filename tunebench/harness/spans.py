"""The traced window's device rows attributed to the program's own spans
(``repro_torch.monitoring.tracing``), for the per-layer metrics that read
the body's parts.

A replayed CUDA graph's rows carry no host span, so they are put down to
spans by order. One stream serialises the window, so the device rows
follow the host's launch calls: the trace's runtime calls that put rows on
the device (``LAUNCH_CALLS``), taken by start time, are expanded: each
``cudaGraphLaunch`` into its graph's rows in node order, with the spans
the tracer recorded at the graph's capture (the program is the one whose
``rt.replay#<index>`` span holds the launch), and each other call into one
row, under the innermost program span that holds the call. The result is
zipped with the device rows sorted by start. Its length must equal the
number of device rows; where it does not, or the program recorded no
tables (a program without spans), there is no attribution and every
reader of it returns None. The run's standard error says expected against
found either way.

The graph rows fall into one part each (``PARTS``, first match wins): the
shield, wherever its spans sit; the fault grid; the window kernel's own
rows; the rest of the window step; the step's control (encode, act,
apply, loading and stabilisation); the policy update; the records mode's
reductions; and the program's root (its rows outside every span). The
eager rows outside the graphs are reported by the span that holds their
launch.
"""
from __future__ import annotations

import sys
from dataclasses import dataclass

REPLAY = "rt.replay#"
#: substrings of the runtime calls that put rows on the device
LAUNCH_CALLS = ("LaunchKernel", "GraphLaunch", "Memcpy", "Memset")
#: the window kernels' device rows (the names ``body_device_ms_per_update``
#: and ``fleet_tick_roofline_pct`` match)
WINDOW_KERNELS = ("fleet_tick", "fleet_scan")
STEP_CONTROL = ("rt.step.encode", "rt.step.act", "rt.step.apply",
                "rt.step.loading")
#: (part, the spans whose rows it takes), in the order a row is tested;
#: the window kernel's rows are told by their device name
PARTS = (("shield", ("rt.shield",)),
         ("fault_grid", ("rt.window.faults",)),
         ("window_kernel", ()),
         ("window_step", ("rt.step.window",)),
         ("step_control", STEP_CONTROL),
         ("policy_update", ("rt.update",)),
         ("records", ("rt.records",)),
         ("root", ()))
#: host spans of the epoch's boundary
BOUNDARY = ("rt.epoch.load", "rt.epoch.adopt", "rt.epoch.summary",
            "rt.epoch.full")


@dataclass
class Attribution:
    #: part -> device ns of the graph rows in it
    graph_ns: dict
    #: part -> graph rows in it
    graph_rows: dict
    #: innermost program span of the launch -> device ns of eager rows
    eager_ns: dict
    eager_rows: dict


def _span_parts(table) -> list:
    """The part of each span of ``table`` by the spans on its path (the
    window kernel's rows are told apart at the zip)."""
    out = []
    for i in range(len(table.names)):
        path = table.path(i)
        out.append(next(part for part, spans in PARTS
                        if any(s in path for s in spans)
                        or part == "root"))
    return out


def _innermost(spans: list, start: int, end: int):
    """The latest-starting of ``spans`` ((name, start, end)) that holds
    [start, end], or None."""
    best = None
    for s in spans:
        if s[1] <= start and end <= s[2] and (best is None or s[1] >= best[1]):
            best = s
    return best


def _log(msg: str) -> None:
    print(f"spans: {msg}", file=sys.stderr, flush=True)


def attribute(trace, tables=None):
    """The ``Attribution`` of ``trace``'s device rows, or None (see the
    module docstring). ``tables`` (program index -> ``SpanTable``) defaults
    to the tracer's."""
    if tables is None:
        try:
            from repro_torch.monitoring.tracing import TABLES
        except ImportError:
            _log("the program records no span tables: no attribution")
            return None
        tables = TABLES
    spans = [(n, s, s + d) for n, s, d in trace.host if n.startswith("rt.")]
    replays = [s for s in spans if s[0].startswith(REPLAY)]
    calls = sorted((r for r in trace.host if r[0].startswith("cu")
                    and any(c in r[0] for c in LAUNCH_CALLS)),
                   key=lambda r: r[1])
    labels = []         # per expected row: a graph row's part, or None
    eager = []          # the span that holds each eager row's launch
    nodes: dict = {}    # program -> the part of each node of its graph
    graphs = 0
    for name, start, dur in calls:
        if "GraphLaunch" not in name:
            held = _innermost(spans, start, start + dur)
            labels.append(None)
            eager.append(held[0] if held else "(no program span)")
            continue
        held = _innermost(replays, start, start + dur)
        table = tables.get(int(held[0][len(REPLAY):])) if held else None
        if table is None:
            _log(f"a {name} at {start} ns has no recorded graph: no "
                 "attribution")
            return None
        graphs += 1
        if table.program not in nodes:
            parts = _span_parts(table)
            nodes[table.program] = [parts[i] for i in table.node_spans()]
        labels.extend(nodes[table.program])
    device = sorted(trace.device, key=lambda r: r[1])
    _log(f"{len(labels)} device rows expected ({graphs} graph launches, "
         f"{len(calls) - graphs} other launch calls), {len(device)} found"
         + ("" if len(labels) == len(device) else ": no attribution"))
    if len(labels) != len(device):
        return None
    out = Attribution({}, {}, {}, {})
    held = iter(eager)
    for part, (name, _, dur) in zip(labels, device):
        if part is None:
            h = next(held)
            out.eager_ns[h] = out.eager_ns.get(h, 0) + dur
            out.eager_rows[h] = out.eager_rows.get(h, 0) + 1
        else:
            if part not in ("shield", "fault_grid") and any(
                    k in name for k in WINDOW_KERNELS):
                part = "window_kernel"
            out.graph_ns[part] = out.graph_ns.get(part, 0) + dur
            out.graph_rows[part] = out.graph_rows.get(part, 0) + 1
    per = lambda ns: f"{ns / 1e6 / trace.updates:.4f}"
    _log("graph rows an update, ms (rows): " + ", ".join(
        f"{p} {per(out.graph_ns[p])} ({out.graph_rows[p] / trace.updates:g})"
        for p, _ in PARTS if p in out.graph_ns)
         + f"; all {per(sum(out.graph_ns.values()))}")
    _log("eager rows an update, ms (rows): " + ", ".join(
        f"{s} {per(ns)} ({out.eager_rows[s] / trace.updates:g})"
        for s, ns in sorted(out.eager_ns.items())))
    return out


_LAST: list = [None, None]          # the last trace read, its attribution


def cached(trace):
    """``attribute(trace)``, computed once for the readers of one trace."""
    if _LAST[0] is not trace:
        _LAST[:] = [trace, attribute(trace)]
    return _LAST[1]


def part_ms_per_update(trace, part: str):
    """Device ms an update of the graph rows in ``part``; None without an
    attribution or where no row fell in it."""
    att = cached(trace)
    if att is None or part not in att.graph_ns:
        return None
    return att.graph_ns[part] / 1e6 / trace.updates


def host_ms(trace, named) -> float:
    """Host ms of the host rows whose name ``named(name)`` takes; None where
    there is none."""
    times = [d for n, _, d in trace.host if named(n)]
    return sum(times) / 1e6 if times else None
