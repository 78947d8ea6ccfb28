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


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version_on_the_card():
    """Builds ``csrc/fleet_tick.cu`` with nvcc and holds the kernel against
    the plain version on CUDA tensors (ragged N, K > S, fault multiplier,
    preroll); counts exactly one launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for T, N, S, p99_k in ((48, 1024, 32, 18), (24, 1000, 8, 40)):
        ops, kw = _inputs(T, N, S, seed=7, fmult=True, preroll=True)
        args = [None if v is None else torch.from_numpy(v.copy()).cuda()
                for v in ops.values()]
        before = ft.LAUNCHES
        got = ft.fleet_tick_window(*args, **kw, p99_k=p99_k)
        torch.cuda.synchronize()
        assert ft.LAUNCHES == before + 1
        ref = ft.fleet_tick_window_ref(*args, **kw, p99_k=p99_k)
        _assert_close(got, ref, f"cuda T={T} N={N} S={S}")
