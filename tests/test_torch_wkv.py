"""``repro_torch.kernels.rwkv6_wkv`` and ``ops.rwkv6_wkv`` against the
reference on identical numpy inputs; and (on a card) the CUDA kernel
against its plain version.

On a CPU tensor the wrapper runs its plain version, the sequential
recurrence. Tolerances: f32 rtol/atol 1e-4 against the same formulation
(the sequential oracle ``ref.rwkv6_wkv_ref``, or the chunked
``wkv6_chunked``/Pallas pair), 1e-3 against the other one (a chunked form
against the sequential one sums in another order; tests/test_kernels.py
holds the Pallas kernel to the oracle at 1e-3 for S_fin). bf16 r/k/v (with
f32 logw and u, as the model feeds them): 3e-2 on o, one bf16 rounding on
each side (the bf16 tolerance of tests/test_kernels.py); S_fin stays f32.

``_tiled_mirror`` is a plain-torch copy of the bf16 kernel's algorithm: the
tiling (16-token sub-chunks), the running-product decay factors referenced
to sub-chunk boundaries, the diagonal scores, and the kernel's operand
roundings (f32 operands split into bf16 hi + lo, the products hi.hi +
hi.lo + lo.hi, v exact in bf16). It is held against the reference's oracle
with the chip check's scaled tolerances (``WKV_TOL`` in chip_smoke.py):
error over max(1, max |oracle|) within 1e-3 for o before its bf16 rounding
and for S_fin, and 3e-2 for o in bf16.

The ``gpu`` tests need neither jax nor the reference, so they run where only
the port is installed:
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_wkv.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rwkv6_wkv as wkv  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

try:  # the reference; absent where only the port is installed
    import jax.numpy as jnp
    from repro.kernels import ops as ref_ops
    from repro.kernels import ref
    from repro.kernels.rwkv6_wkv import rwkv6_wkv as ref_wkv
    from repro.models import layers as RL
except ImportError:  # pragma: no cover - a port-only install
    jnp = ref_ops = ref = ref_wkv = RL = None

needs_reference = pytest.mark.skipif(ref is None,
                                     reason="needs jax and the reference")
#: chip_smoke.py's WKV_TOL: scaled max error, f32 and bf16
WKV_TOL = {"float32": 1e-3, "bfloat16": 3e-2}

SAME = dict(rtol=1e-4, atol=1e-4)
OTHER = dict(rtol=1e-3, atol=1e-3)
BF16 = dict(rtol=3e-2, atol=3e-2)

WKV_CASES = [
    # (B, H, S, hd, chunk): tests/test_kernels.py:120
    (1, 2, 64, 32, 32),
    (2, 2, 70, 32, 32),     # ragged
    (1, 1, 128, 64, 64),    # production-like tile
    (2, 1, 20, 32, 32),     # S < chunk
]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, H, S, hd, seed=0, layout="bhsd", logw_range="test"):
    """r, k, v ~ N(0, 1); logw as tests/test_kernels.py draws it
    (-exp(clip(N, -3, 0.5))), or across the model's whole clip range
    [-8, -1e-6] with both ends present; u ~ N(0, 1). numpy f32."""
    rng = np.random.default_rng(seed)
    shape = (B, H, S, hd) if layout == "bhsd" else (B, S, H, hd)
    r, k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    if logw_range == "test":
        logw = -np.exp(np.clip(rng.standard_normal(shape), -3, 0.5))
    else:
        logw = -np.exp(rng.uniform(np.log(1e-6), np.log(8.0), shape))
        logw.flat[0], logw.flat[-1] = -8.0, -1e-6
    u = rng.standard_normal((H, hd)).astype(np.float32)
    return r, k, v, logw.astype(np.float32), u


def _t(a, dtype="float32"):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _j(a, dtype="float32"):
    return jnp.asarray(a).astype(getattr(jnp, dtype))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@needs_reference
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", WKV_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_plain_version_matches_reference_kernel_and_oracle(case, dtype):
    B, H, S, hd, chunk = case
    r, k, v, logw, u = _inputs(B, H, S, hd)
    o, sfin = wkv.rwkv6_wkv(_t(r, dtype), _t(k, dtype), _t(v, dtype),
                            _t(logw), _t(u), chunk=chunk)
    assert o.dtype == getattr(torch, dtype) and tuple(o.shape) == (B, H, S, hd)
    assert sfin.dtype == torch.float32 and tuple(sfin.shape) == (B, H, hd, hd)
    jin = (_j(r, dtype), _j(k, dtype), _j(v, dtype), _j(logw), _j(u))
    ko, ks = ref_wkv(*jin, chunk=chunk, interpret=True)
    oo, os_ = ref.rwkv6_wkv_ref(*jin)
    if dtype == "float32":
        np.testing.assert_allclose(_f32(o), _f32(oo), **SAME)
        np.testing.assert_allclose(_f32(o), _f32(ko), **OTHER)
    else:
        np.testing.assert_allclose(_f32(o), _f32(oo), **BF16)
        np.testing.assert_allclose(_f32(o), _f32(ko), **BF16)
    np.testing.assert_allclose(_f32(sfin), _f32(os_), **SAME)
    np.testing.assert_allclose(_f32(sfin), _f32(ks), **OTHER)


@needs_reference
@pytest.mark.parametrize("logw_range", ["test", "clip"])
@pytest.mark.parametrize("case", [(2, 2, 70, 32, 16), (1, 2, 20, 32, 32)],
                         ids=lambda c: "x".join(map(str, c)))
def test_wkv6_chunked_matches_reference(case, logw_range):
    """The layer's plain chunked form against the reference's, with and
    without a carried state, over several chunks with a ragged tail and
    with a single chunk longer than S."""
    B, H, S, hd, chunk = case
    r, k, v, logw, u = _inputs(B, H, S, hd, seed=1, layout="bshd",
                               logw_range=logw_range)
    st = np.random.default_rng(2).standard_normal(
        (B, H, hd, hd)).astype(np.float32)
    for state in (None, st):
        o, s = L.wkv6_chunked(*map(_t, (r, k, v, logw, u)), chunk=chunk,
                              state=None if state is None else _t(state))
        oj, sj = RL.wkv6_chunked(*map(_j, (r, k, v, logw, u)), chunk=chunk,
                                 state=None if state is None else _j(state))
        np.testing.assert_allclose(_f32(o), _f32(oj), **SAME)
        np.testing.assert_allclose(_f32(s), _f32(sj), **SAME)


@needs_reference
def test_model_layout_wrapper_matches_reference_with_and_without_state():
    B, H, S, hd = 2, 2, 45, 32
    r, k, v, logw, u = _inputs(B, H, S, hd, seed=3, layout="bshd",
                               logw_range="clip")
    st = np.random.default_rng(4).standard_normal(
        (B, H, hd, hd)).astype(np.float32)
    for state in (None, st):
        o, s = ops.rwkv6_wkv(*map(_t, (r, k, v, logw, u)), chunk=16,
                             state=None if state is None else _t(state))
        oj, sj = ref_ops.rwkv6_wkv(*map(_j, (r, k, v, logw, u)), chunk=16,
                                   state=None if state is None else _j(state))
        assert tuple(o.shape) == (B, S, H, hd)
        tol = OTHER if state is None else SAME  # sequential vs Pallas
        np.testing.assert_allclose(_f32(o), _f32(oj), **tol)
        np.testing.assert_allclose(_f32(s), _f32(sj), **tol)


def _split(x):
    """x (f32) -> (hi, lo) as f32 values of bf16 numbers, as the kernel's
    ``split2``: hi = bf16(x), lo = bf16(x - hi)."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _hilo_matmul(a, b, b_exact=False):
    """a @ b as the kernel's mma.sync products take it: hi.hi + hi.lo +
    lo.hi over bf16 splits of both (b alone when ``b_exact``: v in bf16)."""
    ah, al = _split(a)
    if b_exact:
        return ah @ b + al @ b
    bh, bl = _split(b)
    return ah @ bh + ah @ bl + al @ bh


def _tiled_mirror(r, k, v, logw, u):
    """The bf16 kernel's algorithm in plain torch on (B, H, S, hd) tensors:
    returns (o before its bf16 rounding, S_fin), both f32."""
    B, H, S, hd = r.shape
    sub = wkv.MMA_SUB
    n = -(-S // sub) * sub
    pad = lambda a: torch.nn.functional.pad(a.float(), (0, 0, 0, n - S))
    r, k, v, w = pad(r), pad(k), pad(v), torch.exp(pad(logw))  # w = 1 past S
    u = u.float()
    st = torch.zeros(B, H, hd, hd)
    o = torch.zeros(B, H, n, hd)
    for t0 in range(0, n, sub):
        sl = slice(t0, t0 + sub)
        rs, ks, vs, ws = r[:, :, sl], k[:, :, sl], v[:, :, sl], w[:, :, sl]
        # r decayed from the sub-chunk's start, k to its end: running
        # products of w inside the sub-chunk, each factor in [0, 1]
        x, f = torch.empty_like(rs), torch.ones_like(rs[:, :, 0])
        for t in range(sub):
            x[:, :, t] = rs[:, :, t] * f
            f = f * ws[:, :, t]
        total = f
        kt, f = torch.empty_like(ks), torch.ones_like(ks[:, :, 0])
        for t in range(sub - 1, -1, -1):
            kt[:, :, t] = ks[:, :, t] * f
            f = f * ws[:, :, t]
        # the diagonal block: P[t][s] = sum_c r_tc k_sc prod_{s<q<t} w_qc,
        # the bonus r_t . (u (.) k_t) at s = t
        P = torch.zeros(B, H, sub, sub)
        for t in range(sub):
            gg = rs[:, :, t]
            P[:, :, t, t] = (gg * u[None] * ks[:, :, t]).sum(-1)
            for s in range(t - 1, -1, -1):
                P[:, :, t, s] = (gg * ks[:, :, s]).sum(-1)
                gg = gg * ws[:, :, s]
        o[:, :, sl] = _hilo_matmul(x, st) + _hilo_matmul(P, vs, b_exact=True)
        st = st * total[..., None] + _hilo_matmul(kt.transpose(-1, -2), vs,
                                                  b_exact=True)
    return o[:, :, :S], st


def _scaled(a, b):
    a, b = _f32(a).astype(np.float64), _f32(b).astype(np.float64)
    return np.abs(a - b).max() / max(1.0, np.abs(b).max())


@needs_reference
@pytest.mark.parametrize("logw_range", ["clip", -8.0, -1e-6])
@pytest.mark.parametrize("case", [(1, 2, 70, 32), (2, 1, 20, 64),
                                  (1, 1, 100, 64)],
                         ids=lambda c: "x".join(map(str, c)))
def test_tiled_mirror_of_the_bf16_kernel_matches_the_oracle(case,
                                                            logw_range):
    """A ragged S (70 = 4 sub-chunks + 6), S below one staged chunk, and a
    longer hd-64 case; logw over the model's whole clip range and at both
    ends (-8: every factor underflows within a sub-chunk; -1e-6: the state
    sums every k vT with no decay). r/k/v are bf16 values: the oracle runs
    on their exact f32 copies."""
    B, H, S, hd = case
    r, k, v, logw, u = _inputs(B, H, S, hd, seed=S + hd, logw_range=(
        logw_range if logw_range == "clip" else "test"))
    if logw_range != "clip":
        logw = np.full_like(logw, logw_range)
    r, k, v = (_t(a, "bfloat16") for a in (r, k, v))
    o, sfin = _tiled_mirror(r, k, v, _t(logw), _t(u))
    oo, os_ = ref.rwkv6_wkv_ref(*(_j(_f32(a)) for a in (r, k, v)), _j(logw),
                                _j(u))
    assert _scaled(o, oo) <= WKV_TOL["float32"]
    assert _scaled(sfin, os_) <= WKV_TOL["float32"]
    assert _scaled(o.to(torch.bfloat16), oo) <= WKV_TOL["bfloat16"]
    assert np.isfinite(_f32(o)).all() and np.isfinite(_f32(sfin)).all()


def test_hilo_split_keeps_sixteen_bits():
    """The kernel's operand split: hi + lo is within 2^-16 of x (relative),
    and a hi/lo product within ~3 2^-18 of the f32 one."""
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (64, 64)).astype(np.float32)) * 100
    hi, lo = _split(x)
    assert float(((hi + lo - x).abs() / x.abs()).max()) <= 2.0 ** -16
    y = x.T / 7
    exact = (x.double() @ y.double())
    err = (_hilo_matmul(x, y).double() - exact).abs()
    assert float((err / (x.double().abs() @ y.double().abs())).max()) \
        <= 3 * 2.0 ** -18


def test_launch_layout_takes_model_views_and_refuses_misaligned_bf16():
    """Metadata only (CPU tensors): the model's (B, S, H, hd) tensors seen
    as (B, H, S, hd) pass with their strides; a bf16 row stride that is not
    a multiple of 16 bytes or an unaligned base pointer raises; f32 r/k/v
    (scalar loads) need only hd contiguous."""
    B, S, H, hd = 2, 40, 3, 64
    mk = lambda dt: torch.zeros((B, S, H, hd), dtype=dt).transpose(1, 2)
    r = mk(torch.bfloat16)
    lw = mk(torch.float32)
    st = wkv._launch_layout(r, r, r, lw)
    assert st == (S * H * hd, hd, H * hd) * 3 + (S * H * hd, hd, H * hd)
    one = torch.zeros((1, 1, S, hd), dtype=torch.bfloat16)
    assert wkv._launch_layout(one, one, one, lw[:1, :1])[:3] == (0, 0, hd)
    wide = torch.zeros((B, S, H, hd + 4), dtype=torch.bfloat16)
    bad = wide[..., :hd].transpose(1, 2)      # row stride hd + 4: 8 bytes off
    with pytest.raises(ValueError, match="multiples of 8"):
        wkv._launch_layout(bad, r, r, lw)
    flat = torch.zeros(B * S * H * hd + 1, dtype=torch.bfloat16)
    shifted = flat[1:].view(B, S, H, hd).transpose(1, 2)   # 2 bytes off
    with pytest.raises(ValueError, match="16-byte"):
        wkv._launch_layout(r, shifted, r, lw)
    with pytest.raises(ValueError, match="contiguous"):
        wkv._launch_layout(r.transpose(2, 3), r, r, lw)
    f = wide.float()[..., :hd].transpose(1, 2)
    assert wkv._launch_layout(f, f, f, lw)[2] == H * (hd + 4)


def test_mma_kernel_geometry():
    """The bf16 kernel's shared memory per block (``Geo::BYTES``): two
    blocks an SM at hd 64 (the rwkv6-7b shape, 256 blocks on 132 SMs), one
    at hd 128, all under a block's limit; a block takes 32 or 64 value
    columns."""
    per_sm = 228 * 1024
    assert wkv.mma_smem_bytes(64, 64) == 84_736
    assert per_sm // wkv.mma_smem_bytes(64, 64) == 2
    assert per_sm // wkv.mma_smem_bytes(128, 64) == 1
    for hd in wkv.HEAD_DIMS:
        dv = min(hd, wkv.MMA_VALUE_COLUMNS)
        assert hd % dv == 0 and dv in (32, 64)
        assert wkv.mma_smem_bytes(hd, dv) <= kbuild.MAX_SMEM
    assert wkv.MMA_CHUNK % wkv.MMA_SUB == 0 and wkv.MMA_SUB == 16


def test_wkv_cost_at_the_rwkv6_7b_train_shape():
    """The numbers quoted in the kernel's header: 0.81 GB (~0.24 ms at
    3.35 TB/s) against 17.2 GFLOP (~0.26 ms at 67 TFLOP/s f32, ~0.017 ms at
    989 TFLOP/s on the bf16 tensor cores, so bytes bound the bf16 kernel)."""
    nbytes, flops = wkv.wkv_cost(4, 64, 4096, 64, itemsize=2)
    assert round(nbytes / 1e9, 2) == 0.81
    assert round(flops / 1e9, 1) == 17.2
    assert flops / 67e12 > nbytes / 3.35e12
    assert round(flops / 989e12 * 1e3, 3) == 0.017
    assert flops / 989e12 < nbytes / 3.35e12
    n = 4 * 64 * 4096 * 64
    assert nbytes == n * 12 + 4 * 64 * 64 + 4 * 4 * 64 * 64 * 64


def test_import_builds_nothing_and_cpu_tensors_take_the_plain_version():
    from repro_torch.kernels import build

    before, launches = build.BUILDS, wkv.LAUNCHES
    r, k, v, logw, u = map(_t, _inputs(1, 2, 9, 32))
    o, s = wkv.rwkv6_wkv(r, k, v, logw, u, chunk=4)
    o2, s2 = wkv.rwkv6_wkv_ref(r, k, v, logw, u)
    assert torch.equal(o, o2) and torch.equal(s, s2)
    assert build.BUILDS == before and wkv.LAUNCHES == launches


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version_on_the_card():
    """Every case above, through the kernel on the card against the plain
    chunked version on the same tensors, in f32 and with bf16 r/k/v, from
    contiguous (B,H,S,hd) tensors and from the model layout's strided
    views; the staging tile does not change the result. The bf16 kernel's
    edges: S of 1, one sub-chunk, one sub-chunk + 1, one staged chunk + 1;
    hd 128 (two value-column blocks); logw at both clip ends."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cases = [c[:4] + ("clip",) for c in WKV_CASES] + [
        (2, 4, 300, 64, "clip"), (1, 2, 50, 128, "clip"),
        (2, 3, 1, 64, "clip"), (1, 2, 16, 64, "clip"), (1, 2, 17, 32, "clip"),
        (1, 2, 33, 128, "clip"), (1, 2, 200, 64, -8.0),
        (1, 2, 200, 64, -1e-6)]
    for i, (B, H, S, hd, lwr) in enumerate(cases):
        r, k, v, logw, u = (_t(a).cuda() for a in _inputs(
            B, H, S, hd, seed=i, layout="bshd",
            logw_range="clip" if lwr == "clip" else "test"))
        if lwr != "clip":
            logw.fill_(lwr)
        want_o, want_s = L.wkv6_chunked(r, k, v, logw, u, chunk=32)
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            rd, kd, vd = (a.to(dt) for a in (r, k, v))
            if dtype == "bfloat16":
                want_o, want_s = L.wkv6_chunked(rd, kd, vd, logw, u, chunk=32)
            before = wkv.LAUNCHES
            o, s = ops.rwkv6_wkv(rd, kd, vd, logw, u, chunk=32)
            o2, s2 = wkv.rwkv6_wkv(*(a.transpose(1, 2).contiguous()
                                     for a in (rd, kd, vd, logw)), u, chunk=7)
            torch.cuda.synchronize()
            assert wkv.LAUNCHES == before + 2 and o.dtype == dt
            tol = OTHER if dtype == "float32" else BF16
            np.testing.assert_allclose(_f32(o.cpu()),
                                       _f32(want_o.to(dt).cpu()), **tol)
            np.testing.assert_allclose(_f32(s.cpu()), _f32(want_s.cpu()),
                                       **OTHER)
            assert torch.equal(o2.transpose(1, 2), o) and torch.equal(s2, s)


@pytest.mark.gpu
def test_cuda_kernel_refuses_misaligned_bf16_rows():
    """A bf16 view whose rows do not start 16-byte aligned raises before
    any launch; its f32 twin launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    B, S, H, hd = 1, 20, 2, 64
    wide = torch.zeros((B, S, H, hd + 4), device="cuda")
    r = wide[..., :hd].transpose(1, 2)          # head stride hd + 4
    rb = wide.to(torch.bfloat16)[..., :hd].transpose(1, 2)
    lw = torch.full((B, H, S, hd), -0.5, device="cuda")
    u = torch.zeros((H, hd), device="cuda")
    before = wkv.LAUNCHES
    with pytest.raises(ValueError, match="multiples of 8"):
        wkv.rwkv6_wkv(rb, rb, rb, lw, u)
    assert wkv.LAUNCHES == before
    wkv.rwkv6_wkv(r, r, r, lw, u)
    torch.cuda.synchronize()
    assert wkv.LAUNCHES == before + 1
