"""The port's program spans (``repro_torch.monitoring.tracing``).

On the CPU:
* with no profiler, ``span()`` is one shared null context;
* under the CPU profiler, ``run_epoch`` emits the host spans and, in its
  body's eager call, the step's spans S times each, nested as the
  tracer's readers expect;
* the capture table's bookkeeping, with a counter standing in for the CUDA
  driver: counts at entry and exit, parents, the root's remainder;
* no span name holds what readers of a trace match in the profiler's own
  rows.

On a card (``-m gpu``): a captured body's replayed rows, put down to spans
by the table, equal its eager call's rows span by span, in count and (to
10 %) in device time.
"""
from collections import Counter

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.core import Configurator  # noqa: E402
from repro_torch.core.faults import chaos_scenario  # noqa: E402
from repro_torch.data.workloads import PoissonWorkload  # noqa: E402
from repro_torch.engine import FleetEnv  # noqa: E402
from repro_torch.monitoring import tracing  # noqa: E402

METRICS = ["latency_p99_ms", "latency_mean_ms", "queue_depth", "device_util",
           "sched_queue_depth"]
LEVERS = ["max_batch_events", "prefetch_depth", "driver_memory_gb",
          "sink_partitions", "backup_tasks"]
FROZEN = dict(split_after=10**9, extend_after=10**9, merge_after=10**9)
S = 2
#: the spans of one step, and where each sits
STEP = ("rt.step.encode", "rt.step.act", "rt.step.apply", "rt.step.loading",
        "rt.step.window")
WINDOW = ("rt.window.core", "rt.window.emit")
#: what readers of a trace match in the profiler's own row names
READER_MATCHES = ("LaunchKernel", "GraphLaunch", "fleet_tick")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fleet(n=4, *, chaos=True, device="cpu"):
    """``chaos``: faults, a deploy delay, the SLO reward and the shield, so
    every span of the body runs."""
    kw = {}
    if chaos:
        kw = dict(reward_mode="slo", slo_ms=2000.0, safe=True,
                  shield_kw=dict(trust_radius=1, breach_budget=2))
    env = FleetEnv([PoissonWorkload(10_000, 0.5) for _ in range(n)],
                   seeds=list(range(n)), backend="torch", device=device,
                   faults=(chaos_scenario(n, t0_s=500.0, deploy_delay=1)
                           if chaos else None))
    return Configurator(env, METRICS, LEVERS, seed=3, steps_per_episode=S,
                        window_s=240.0, device_loop="on", bin_kw=FROZEN,
                        **kw)


def _host_spans(prof) -> list:
    """The ``rt.`` spans of a profile as (name, start, end, parent name),
    the parent the innermost ``rt.`` span that holds it (None: none)."""
    rows = sorted(((e.name(), e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith("rt.")), key=lambda r: (r[1], -r[2]))
    out, stack = [], []
    for name, s, e in rows:
        while stack and stack[-1][2] < e:
            stack.pop()
        out.append((name, s, e, stack[-1][0] if stack else None))
        stack.append((name, s, e))
    return out


def test_span_without_a_profiler_is_the_shared_null_context():
    a, b = tracing.span("rt.a"), tracing.span("rt.b")
    assert a is b is tracing._NULL
    with a:
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        on = tracing.span("rt.a")
    assert on is not tracing._NULL
    assert isinstance(on, torch.profiler.record_function)


@pytest.mark.parametrize("chaos,records", [(True, "summary"),
                                           (False, "full")],
                         ids=["shielded-summary", "plain-full"])
def test_run_epoch_spans_nest_under_the_cpu_profiler(chaos, records):
    cfgr = _fleet(chaos=chaos)
    cfgr.run_epoch(2, records=records)      # past the exploit warm-up
    k = 2
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        cfgr.run_epoch(k, records=records)
    spans = _host_spans(prof)
    # rt.program#3 -> rt.program
    base = lambda name: name and name.split("#")[0]
    parent = {}
    for name, _, _, up in spans:
        parent.setdefault(base(name), set()).add(base(up))
    count = Counter(base(name) for name, *_ in spans)
    # the host's epoch path
    assert parent["rt.configurator.run_epoch"] == {None}
    assert parent["rt.configurator.checks"] == {"rt.configurator.run_epoch"}
    assert parent["rt.epoch"] == {"rt.configurator.run_epoch"}
    boundary = "rt.epoch.summary" if records == "summary" else "rt.epoch.full"
    for name in ("rt.epoch.load", "rt.epoch.program", "rt.epoch.outputs",
                 "rt.epoch.sync", "rt.epoch.adopt", boundary):
        assert parent[name] == {"rt.epoch"}, name
    assert count["rt.epoch.outputs"] == k + 1     # k clones, one stack
    # the body: one eager call an update on the CPU
    assert count["rt.program"] == k and parent["rt.program"] == {"rt.epoch"}
    for name in STEP:
        assert count[name] == k * S and parent[name] == {"rt.program"}
    for name in WINDOW:
        assert count[name] == k * S and parent[name] == {"rt.step.window"}
    assert count["rt.update"] == k and parent["rt.update"] == {"rt.program"}
    programs = {name for name, *_ in spans if name.startswith("rt.program#")}
    assert len(programs) == 1
    if chaos:
        assert count["rt.window.faults"] == k * S
        assert parent["rt.window.faults"] == {"rt.step.window"}
        # mask and diversion in act, clamp and fallback in apply, the
        # update after the window
        assert count["rt.shield"] == 4 * k * S
        assert parent["rt.shield"] == {"rt.step.act", "rt.step.apply",
                                       "rt.program"}
        assert count["rt.records"] == 2 * k
    else:
        assert {"rt.window.faults", "rt.shield", "rt.records"}.isdisjoint(
            count)
    assert "rt.replay" not in count and "rt.capture" not in count


def test_capture_table_bookkeeping():
    """``recording`` with a counter standing in for the driver: each span's
    entry and exit counts, its parent, and the nodes no span holds falling
    to the root."""
    nodes = [0]

    def launch(n):
        nodes[0] += n

    idx = tracing.program_index()
    with tracing.recording(idx, lambda: nodes[0]):
        launch(2)                                   # root: nodes 0-1
        with tracing.span("rt.step.act"):           # 2-6
            launch(1)
            with tracing.span("rt.shield"):         # 3-4
                launch(2)
            launch(2)
        with tracing.span("rt.update"):             # 7-9
            launch(3)
        with tracing.span("rt.records"):            # none
            pass
        launch(1)                                   # root: 10
    table = tracing.TABLES[idx]
    assert table.program == idx and table.nodes == 11
    assert table.names == (f"rt.program#{idx}", "rt.step.act", "rt.shield",
                           "rt.update", "rt.records")
    assert table.parents == (-1, 0, 1, 0, 0)
    assert table.enter == (0, 2, 3, 7, 10)
    assert table.exit == (11, 7, 5, 10, 10)
    owner = table.node_spans()
    assert owner == [0, 0, 1, 2, 2, 1, 1, 3, 3, 3, 0]
    assert Counter(owner) == {0: 3, 1: 3, 2: 2, 3: 3}
    assert sum(Counter(owner).values()) == table.nodes
    assert table.path(2) == ("rt.shield", "rt.step.act", f"rt.program#{idx}")
    # outside a recording nothing is recorded, and a failed one keeps none
    assert tracing._recording is None
    bad = tracing.program_index()
    with pytest.raises(ValueError):
        with tracing.recording(bad, lambda: 0):
            raise ValueError("capture failed")
    assert bad not in tracing.TABLES and tracing._recording is None


def test_span_names_hold_nothing_the_readers_match():
    cfgr = _fleet(chaos=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        cfgr.run_epoch(1, records="summary")
    names = {name for name, *_ in _host_spans(prof)}
    names |= {f"rt.{kind}#{i}" for kind in ("program", "capture", "replay")
              for i in (0, 17)}
    assert len(names) >= 20
    for name in names:
        assert name.startswith("rt.") and not name.startswith("tunebench.")
        assert not any(m in name for m in READER_MATCHES), name


@pytest.mark.gpu
def test_replayed_rows_match_the_eager_call_span_by_span_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfgr = _fleet(1024, device="cuda")
    cfgr.run_epoch(2, records="summary")    # warm-up program: eager, capture
    cfgr.run_epoch(2, records="summary")    # the exploiting body: the same
    prog = max(cfgr._runner._programs.values(), key=lambda p: p.index)
    table = tracing.TABLES[prog.index]
    names = [table.names[i] for i in table.node_spans()]
    assert prog.graph is not None and table.nodes > 1000

    def profiled(fn, reps=3):
        for _ in range(reps):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            yield prof

    # the replay: the rows of its graph launch, in start order, are the
    # graph's nodes in order (the replay's other launches, which advance
    # the draw stream, are left out)
    rep_n, rep_ns = Counter(), Counter()
    for prof in profiled(prog):
        events = list(prof.profiler.kineto_results.events())
        graph = {e.correlation_id() for e in events
                 if e.name() == "cudaGraphLaunch"}
        dev = sorted((e.start_ns(), e.duration_ns()) for e in events
                     if e.device_type() == torch.autograd.DeviceType.CUDA
                     and not e.is_user_annotation()
                     and e.correlation_id() in graph)
        assert len(graph) == 1 and len(dev) == table.nodes
        for name, (_, d) in zip(names, dev):
            rep_n[name] += 1
            rep_ns[name] += d
    # the eager call: each row by its launch's correlation id, under the
    # innermost span that holds the launch
    eag_n, eag_ns = Counter(), Counter()
    root = table.names[0]
    for prof in profiled(lambda: _eager(prog, root)):
        events = list(prof.profiler.kineto_results.events())
        spans = _host_spans(prof)
        launch = {e.correlation_id(): e.start_ns() for e in events
                  if e.device_type() != torch.autograd.DeviceType.CUDA
                  and e.name().startswith("cu")}
        for e in events:
            if (e.device_type() != torch.autograd.DeviceType.CUDA
                    or e.is_user_annotation()):
                continue
            t = launch[e.correlation_id()]
            held = max((s for s in spans if s[1] <= t <= s[2]),
                       key=lambda s: s[1])
            eag_n[held[0]] += 1
            eag_ns[held[0]] += e.duration_ns()
    assert rep_n == eag_n
    for name in rep_n:
        assert rep_ns[name] == pytest.approx(eag_ns[name], rel=0.10), name


def _eager(prog, root):
    """The program's function run eagerly on the current stream, under its
    root span's name as its capture recorded it."""
    with tracing.span(root):
        prog.fn()
