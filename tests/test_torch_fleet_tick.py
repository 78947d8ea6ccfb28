"""``repro_torch.kernels.fleet_tick``: the plain version against the
reference TPU kernel's tiers on identical numpy inputs, and (on a card) the
CUDA kernel against the plain version.

Tolerance: rtol 1e-5 / atol 1e-5 (f32). Both sides run the same f32
formulas in the same order, sort exactly (min/max networks vs torch.sort)
and sum the lanes in the same adjacent-pair order; what differs is XLA's
multiply-add fusion, a last-bit effect (measured worst ~1.3e-6 relative on
the carried state). Infinite/NaN entries (the quantile rows of ticks
outside the window, the head's -inf padding) must match position for
position.

The ``gpu`` test needs neither jax nor the reference, so it runs where
only the port is installed:
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_fleet_tick.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import fleet_tick as ft  # noqa: E402

try:  # the reference; absent where only the port is installed
    import jax.numpy as jnp
    from repro.engine import FleetEnv as RefFleetEnv
    from repro.kernels import fleet_tick as ref_ft
except ImportError:  # pragma: no cover - a port-only install
    jnp = RefFleetEnv = ref_ft = None

needs_reference = pytest.mark.skipif(ref_ft is None,
                                     reason="needs jax and the reference")

RTOL, ATOL = 1e-5, 1e-5
NAMES = ("state", "ys", "stats", "head")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(T, N, S, seed=0, fmult=False, preroll=False):
    """Operands at one (T, N, S) point as numpy: real packed constants of a
    heterogeneous fleet (the port's copy of the lever packing), seeded noise,
    an optional fault multiplier and an optional window mask with a
    stabilisation preroll and ragged ends."""
    from repro_torch.engine import FleetEnv

    env = FleetEnv.heterogeneous(N, seed=seed, device="cpu")
    cc = {k: torch.as_tensor(v, dtype=torch.float32)
          for k, v in env.packed().items()}
    mc = {k: torch.as_tensor(v, dtype=torch.bool if v.dtype == bool
                             else torch.float32) for k, v in env.mc.items()}
    consts = ft.pack_tick_consts(cc, mc, env.spec, env.chips).numpy()
    rng = np.random.default_rng(seed)
    f = lambda a: np.asarray(a, np.float32)
    t_ax = np.arange(T)[:, None]
    n_ticks = rng.integers(max(T // 2, 1), T + 1, N)
    ops = dict(
        state=f(np.stack([rng.uniform(0, 5e4, N), rng.uniform(0, 5, N)])),
        consts=consts,
        rate=f(rng.uniform(5e3, 6e4, (T, N))),
        size=f(rng.uniform(0.001, 5.0, (T, N))),
        z=f(rng.standard_normal((T, N))),
        u_strag=f(rng.random((T, N))), u_raw=f(rng.random((T, N))),
        u_fail=f(rng.random((T, N))),
        active=f(t_ax < n_ticks[None, :]),
        u_wait=f(rng.random((T, S, N))),
        z2a=f(np.abs(rng.standard_normal((T, S, N)))),
        fmult=f(np.where(rng.random((T, N)) < 0.2,
                         rng.uniform(1.0, 4.0, (T, N)), 1.0)) if fmult else None,
        wmask=f((t_ax < n_ticks[None, :])
                & (t_ax >= rng.integers(0, T // 3 + 1, N)[None, :]))
        if preroll else None)
    kw = dict(noise=env.spec.noise, retention_s=env.spec.retention_s,
              straggler_prob=env.spec.straggler_prob,
              slo=env.spec.straggler_slow[0], shi=env.spec.straggler_slow[1])
    return ops, kw


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _assert_close(got, ref, label=""):
    for name, a, b in zip(NAMES, got, ref):
        a, b = _np(a), _np(b)
        assert a.shape == b.shape, (label, name, a.shape, b.shape)
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b),
                                      err_msg=f"{label} {name} finite mask")
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        fin = np.isfinite(b)
        np.testing.assert_allclose(a[fin], b[fin], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{label} {name}")
        np.testing.assert_array_equal(a[~fin & ~np.isnan(b)],
                                      b[~fin & ~np.isnan(b)])


def _torch_args(ops):
    return [None if v is None else torch.from_numpy(v.copy())
            for v in ops.values()]


@needs_reference
@pytest.mark.parametrize("T,N,S,p99_k,fmult,preroll", [
    (48, 16, 32, 18, False, False),   # the fused step's shape (K = S)
    (24, 13, 8, 40, True, True),      # ragged N, K > S, fault multiplier
    (16, 9, 16, 4, True, False),      # K = S, fault multiplier only
    (32, 130, 32, 12, False, True),   # more clusters than one TPU block
    (12, 5, 8, 64, True, True),       # head longer than all lanes (K > T·S)
])
def test_plain_matches_reference_xla_tier(T, N, S, p99_k, fmult, preroll):
    ops, kw = _inputs(T, N, S, seed=T + N, fmult=fmult, preroll=preroll)
    ref = ref_ft.fleet_tick_window(
        *[None if v is None else jnp.asarray(v) for v in ops.values()],
        **kw, p99_k=p99_k, mode="xla")
    got = ft.fleet_tick_window(*_torch_args(ops), **kw, p99_k=p99_k)
    assert got[3].shape[0] == ft.head_budget(S, p99_k) == ref[3].shape[0]
    _assert_close(got, ref, f"T={T} N={N} S={S}")


@needs_reference
def test_plain_matches_reference_interpret_tier():
    """The literal Pallas kernel body, run by the interpreter."""
    ops, kw = _inputs(10, 8, 16, seed=1, fmult=True, preroll=True)
    ref = ref_ft.fleet_tick_window(
        *[jnp.asarray(v) for v in ops.values()], **kw, p99_k=4, block_n=8,
        mode="interpret")
    got = ft.fleet_tick_window(*_torch_args(ops), **kw, p99_k=4)
    _assert_close(got, ref, "interpret")


@needs_reference
def test_pack_tick_consts_matches_reference():
    env = RefFleetEnv.heterogeneous(12, seed=2, backend="numpy")
    cfgs = env.current_configs()
    for i, c in enumerate(cfgs):      # move every packed lever off default
        c.update(model_axis_size=(4, 8, 16, 32)[i % 4],
                 microbatch_count=(1, 2, 4, 8)[i % 4],
                 expert_parallel=bool(i % 2), backup_tasks=bool(i % 3),
                 allocator_arena_mb=64.0 * (i + 1), sink_partitions=i + 1,
                 failure_inject_frac=0.01 * i)
    env.apply_configs(cfgs)
    cc = {k: np.asarray(v, np.float32) for k, v in env.packed().items()}
    mc = {k: np.asarray(v, np.float32) if v.dtype != bool else v
          for k, v in env.mc.items()}
    ref = ref_ft.pack_tick_consts({k: jnp.asarray(v) for k, v in cc.items()},
                                  {k: jnp.asarray(v) for k, v in mc.items()},
                                  env.spec, env.chips, xp=jnp)
    got = ft.pack_tick_consts({k: torch.from_numpy(v) for k, v in cc.items()},
                              {k: torch.from_numpy(v) for k, v in mc.items()},
                              env.spec, env.chips)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)


def test_helpers_and_shape_checks():
    for S, k, K in ((32, 18, 32), (8, 40, 56), (16, 4, 16), (64, 2, 64)):
        assert ft.head_budget(S, k) == K
    x = torch.arange(16.0).reshape(8, 2)
    assert torch.equal(ft._sum0(x), x.sum(0))
    nbytes, _ = ft.window_cost(48, 32, 32, 1024)
    # state in/out, the 11 coefficient rows the kernel reads, 9 (T, N)
    # grids, 2 (T, S, N) lane tiles, ys 7T, stats 5T, head K
    assert ft.CONSTS_USED == 11
    assert nbytes == 4 * 1024 * (15 + 21 * 48 + 2 * 48 * 32 + 32)
    # the plain path counts no kernel launches
    ops, kw = _inputs(8, 4, 8)
    before = ft.LAUNCHES
    ft.fleet_tick_window(*_torch_args(ops), **kw)
    assert ft.LAUNCHES == before


@pytest.mark.parametrize("N,T,S,p99_k,geo", [
    # chip_smoke.py's phase-3 shapes: the fused step, the observe window,
    # a long ragged window, a K > S head on a ragged N, a window of 768
    # ticks (16 head-merge values a lane), one of 3328 ticks (past 32
    # values a lane: the head in shared memory), and a head too long for
    # the tile's shared memory (in global memory)
    (1024, 48, 32, 18, (32, 1, 1, 2, 256, 128, 10368, "registers", 0)),
    (1024, 24, 64, 18, (32, 1, 2, 4, 256, 128, 19584, "registers", 0)),
    (1000, 192, 8, 18, (8, 4, 1, 4, 64, 125, 3456, "registers", 0)),
    (777, 32, 16, 40, (16, 2, 1, 4, 128, 98, 5760, "registers", 0)),
    (1024, 768, 8, 64, (8, 4, 1, 16, 64, 128, 3456, "registers", 0)),
    (1024, 3328, 8, 269, (8, 4, 1, 64, 64, 128, 36480, "shared", 0)),
    (1000, 16, 8, 8000,
     (8, 4, 1, 1024, 64, 125, 3456, "global", 125 * 8 * 2 * 8192)),
], ids=["fused-step", "observe", "long-ragged", "k-above-s", "long-window",
        "memory-head", "global-head"])
def test_launch_geometry_at_the_chip_check_shapes(N, T, S, p99_k, geo):
    """Lanes a cluster, clusters a warp, lane values and head-merge values
    a lane, threads, blocks, shared-memory bytes, where the head lives and
    the global workspace of the kernel's launch (``launch_geometry``), at
    every (N, T, S, K) the chip check runs."""
    from repro_torch.engine.fleet_torch import p99_depth

    if p99_k < 1000:
        assert p99_depth(T, S) == p99_k or (T, S) == (32, 16)
    K = ft.head_budget(S, p99_k)
    got = ft.launch_geometry(N, T, S, K)
    keys = ("lanes", "clusters_per_warp", "lane_values", "values_per_lane",
            "threads", "blocks", "smem_bytes", "head", "workspace_floats")
    assert tuple(got[k] for k in keys) == geo
    assert got["lanes"] * got["lane_values"] == S
    assert got["lanes"] * got["values_per_lane"] == K + S
    assert got["clusters_per_warp"] * got["lanes"] == 32
    assert got["blocks"] * ft.TILE_CLUSTERS >= N > (got["blocks"] - 1) * 8
    assert got["smem_bytes"] <= 48 * 1024   # no opt-in needed


@pytest.mark.parametrize("S,K,match", [
    (4, 4, "lanes"), (12, 4, "lanes"), (128, 128, "lanes"),
    (32, 16, "power of two"), (8, 0, "power of two"),
    (8, 100, "power of two"), (64, 0, "power of two"),
])
def test_launch_geometry_refuses_what_the_kernel_is_not_built_for(S, K,
                                                                 match):
    with pytest.raises(ValueError, match=match):
        ft.launch_geometry(64, 8, S, K)


@pytest.mark.parametrize("S,K,head", [
    (8, 120, "registers"), (8, 248, "registers"), (32, 480, "registers"),
    (64, 960, "registers"), (8, 504, "shared"), (16, 1008, "shared"),
    (32, 2016, "shared"), (64, 1984, "shared"), (8, 2040, "shared"),
    (8, 4088, "global"), (8, 8184, "global"), (64, 8128, "global"),
])
def test_launch_geometry_places_the_head_by_its_length(S, K, head):
    """Up to ``MAX_VALUES_PER_LANE`` values a lane the head is merged in
    registers; past it each cluster keeps two head buffers and its sorted
    lanes, 2 (K + S) floats (padded by the lanes a cluster): in shared
    memory while the tile's and the staging fit a block's limit, else in a
    global workspace for every cluster of every block."""
    from repro_torch.kernels import build as kbuild

    N = 1000
    geo = ft.launch_geometry(N, 8, S, K)
    lanes, P = min(S, 32), K + S
    staging = ft.STAGES * (ft.GRIDS * 8 + 2 * S * 9) * 4
    assert geo["values_per_lane"] == P // lanes
    assert geo["head"] == head
    if head == "registers":
        assert geo["values_per_lane"] <= ft.MAX_VALUES_PER_LANE
        assert geo["smem_bytes"] == staging
        assert geo["workspace_floats"] == 0
        return
    assert geo["values_per_lane"] > ft.MAX_VALUES_PER_LANE
    if head == "shared":
        assert geo["smem_bytes"] == staging + 8 * (2 * P + lanes) * 4
        assert geo["smem_bytes"] <= kbuild.MAX_SMEM
        assert geo["workspace_floats"] == 0
    else:
        assert staging + 8 * (2 * P + lanes) * 4 > kbuild.MAX_SMEM
        assert geo["smem_bytes"] == staging
        assert geo["workspace_floats"] == geo["blocks"] * 8 * 2 * P


def test_launch_geometry_covers_the_lane_counts_the_port_uses():
    """Every (S, K) the CUDA path can produce launches: lanes from
    ``lane_budget``, the head from ``p99_depth``, over every window of 1 to
    400 ticks and every ``_bucket`` length up to 65536 ticks (the fused
    loop's and ``observe_fleet``'s padded windows). The register merge
    takes windows up to 3072 ticks; from 3328 ticks the head is in shared
    memory, and only past ~25k ticks in global memory."""
    from repro_torch.engine.fleet_torch import _bucket, lane_budget, p99_depth
    from repro_torch.kernels import build as kbuild

    lengths = sorted(set(range(1, 401))
                     | {_bucket(n) for n in range(1, 65537)})
    assert 768 in lengths and 2048 in lengths and lengths[-1] == 65536
    heads = {}
    for T in lengths:
        S = lane_budget(T)
        K = ft.head_budget(S, p99_depth(T, S))
        geo = ft.launch_geometry(1024, T, S, K)
        assert geo["lanes"] * geo["values_per_lane"] == K + S
        assert geo["smem_bytes"] <= kbuild.MAX_SMEM
        assert (geo["head"] == "registers") == \
            (geo["values_per_lane"] <= ft.MAX_VALUES_PER_LANE)
        heads.setdefault(geo["head"], []).append(T)
    assert max(heads["registers"]) == 3072
    assert min(heads["shared"]) == 3328
    assert min(heads["global"]) > 25_000


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version_on_the_card():
    """Builds ``csrc/fleet_tick.cu`` with nvcc and holds the kernel against
    the plain version on CUDA tensors (ragged N, K > S, fault multiplier,
    preroll); counts exactly one launch per call; every output bitwise equal.
    The warp layout's edges: two lane values a lane (S = 64), 8 to 32
    head-merge values a lane, the smallest head (K = S = 8), one tick, fewer
    clusters than a tile, a partial last tile, and the head merged by rank
    in shared and in global memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for T, N, S, p99_k in ((48, 1024, 32, 18), (24, 1000, 8, 40),
                           (1, 13, 64, 2), (5, 3, 16, 100), (7, 21, 8, 2),
                           (9, 50, 32, 60), (40, 77, 64, 30),
                           # 16 and 32 head-merge values a lane (a window
                           # of 768 ticks among them)
                           (768, 1024, 8, 64), (5, 3, 16, 300),
                           (9, 50, 32, 480), (40, 77, 64, 200),
                           (40, 77, 64, 900),
                           # the head in shared memory at each (lanes, lane
                           # values) instantiation, a window of 3328 ticks
                           # among them, and in global memory
                           (3328, 1024, 8, 269), (5, 3, 16, 1000),
                           (9, 50, 32, 1000), (40, 77, 64, 1000),
                           (16, 300, 8, 8000)):
        geo = ft.launch_geometry(N, T, S, ft.head_budget(S, p99_k))
        ops, kw = _inputs(T, N, S, seed=7, fmult=True, preroll=True)
        args = [None if v is None else torch.from_numpy(v.copy()).cuda()
                for v in ops.values()]
        before = ft.LAUNCHES
        got = ft.fleet_tick_window(*args, **kw, p99_k=p99_k)
        torch.cuda.synchronize()
        assert ft.LAUNCHES == before + 1
        ref = ft.fleet_tick_window_ref(*args, **kw, p99_k=p99_k)
        _assert_close(got, ref, f"cuda T={T} N={N} S={S}")
        for name, a, b in zip(NAMES, got, ref):  # the contract: bitwise
            assert torch.equal(a.isnan(), b.isnan()), (name, T, N, S)
            assert torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0)), \
                (name, T, N, S, geo["head"])
