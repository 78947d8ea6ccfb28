"""``repro_torch.kernels.mamba2_ssd`` and ``ops.mamba2_ssd`` against the
reference on identical numpy inputs; and (on a card) the CUDA kernel
against its plain versions.

On a CPU tensor the wrapper runs its plain version, the sequential scan.
Tolerances are those of tests/test_kernels.py: f32 rtol/atol 2e-4 (a
chunked form and the sequential scan sum in other orders), bf16 3e-2 (the
output is rounded to bf16 on both sides).

``_tiled_mirror`` is a plain-torch copy of the kernel's algorithm: the
16-token sub-chunks, cum from each sub-chunk's start, every decay the
exponent of a masked difference, and the kernel's operand roundings (f32
operands split into TF32 hi + lo, hi rounded and lo truncated as the mma
reads it, the products hi.hi + hi.lo + lo.hi, bf16 x/bm/cm exact). It is
held against the reference's oracle and its Pallas kernel in interpret mode
at the f32 2e-4, with loga at 0, at -80 a step and drawn as the chip check
draws it.

The ``gpu`` test needs neither jax nor the reference, so it runs where only
the port is installed:
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_ssd.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
F = torch.nn.functional

from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import mamba2_ssd as ssd  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

try:  # the reference; absent where only the port is installed
    import jax.numpy as jnp
    from repro.kernels import ops as ref_ops
    from repro.kernels import ref
    from repro.kernels.mamba2_ssd import mamba2_ssd as ref_ssd
except ImportError:  # pragma: no cover - a port-only install
    jnp = ref_ops = ref = ref_ssd = None

needs_reference = pytest.mark.skipif(ref is None,
                                     reason="needs jax and the reference")

TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}

SSD_CASES = [
    # (B, nh, S, hd, ns, chunk): tests/test_kernels.py:77
    (1, 2, 64, 32, 16, 32),
    (2, 3, 100, 32, 16, 32),   # ragged
    (1, 1, 256, 64, 64, 128),  # production-like tile
    (2, 2, 40, 32, 16, 64),    # S < chunk
]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, nh, S, hd, ns, seed=0, loga="test"):
    """x, bm, cm ~ N(0, 1); loga = -softplus(N(0, 1)) <= 0, as
    tests/test_kernels.py draws them; or (``loga="drawn"``) as mamba2_mix
    feeds the scan and chip_smoke.py draws it: dt = softplus(N(0, 1)),
    A = -exp(U(0, log 16)) per head, x scaled by dt, loga = dt A (down to
    ~-80 a step); or every step at the number ``loga``. numpy f32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, nh, S, hd)).astype(np.float32)
    bm = rng.standard_normal((B, S, ns)).astype(np.float32)
    cm = rng.standard_normal((B, S, ns)).astype(np.float32)
    la = -np.logaddexp(0.0, rng.standard_normal((B, nh, S)))
    if loga == "drawn":
        dt = -la
        A = -np.exp(np.log(16.0) * rng.random(nh))
        x, la = x * dt[..., None], dt * A[None, :, None]
    elif loga != "test":
        la = np.full((B, nh, S), float(loga))
    return x.astype(np.float32), bm, cm, la.astype(np.float32)


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
@pytest.mark.parametrize("case", SSD_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_plain_versions_match_reference_kernel_and_oracle(case, dtype):
    """The wrapper's plain (sequential) version and the plain chunked form
    against the reference's Pallas kernel in interpret mode and its
    sequential oracle."""
    B, nh, S, hd, ns, chunk = case
    x, bm, cm, loga = _inputs(B, nh, S, hd, ns)
    tin = (_t(x, dtype), _t(bm, dtype), _t(cm, dtype), _t(loga))
    jin = (_j(x, dtype), _j(bm, dtype), _j(cm, dtype), _j(loga))
    y = ssd.mamba2_ssd(*tin, chunk=chunk)
    yc = ssd.mamba2_ssd_chunked(*tin, chunk=chunk)
    assert y.dtype == yc.dtype == getattr(torch, dtype)
    assert tuple(y.shape) == tuple(yc.shape) == (B, nh, S, hd)
    kern = ref_ssd(*jin, chunk=chunk, interpret=True)
    oracle = ref.mamba2_ssd_ref(*jin)
    for got in (y, yc):
        np.testing.assert_allclose(_f32(got), _f32(kern), **TOL[dtype])
        np.testing.assert_allclose(_f32(got), _f32(oracle), **TOL[dtype])


@needs_reference
def test_ops_wrapper_matches_reference():
    x, bm, cm, loga = _inputs(2, 3, 70, 32, 16, seed=1)
    y = ops.mamba2_ssd(*map(_t, (x, bm, cm, loga)), chunk=32)
    want = ref_ops.mamba2_ssd(*map(_j, (x, bm, cm, loga)), chunk=32)
    np.testing.assert_allclose(_f32(y), _f32(want), **TOL["float32"])


def test_inclusive_decay_and_padding_across_chunks():
    """A hand-checked case across a chunk boundary with a ragged tail:
    y_t reads the state after step t's own decay (inclusive), and the
    chunked form gives the sequential answer however S splits."""
    B, nh, S, hd, ns = 1, 1, 7, 32, 16
    x = torch.zeros((B, nh, S, hd))
    x[0, 0, 0, 0] = 1.0
    bm = torch.ones((B, S, ns))
    cm = torch.ones((B, S, ns)) / ns
    loga = torch.full((B, nh, S), -0.5)
    want = torch.exp(-0.5 * torch.arange(S, dtype=torch.float32))
    for chunk in (2, 3, 7, 16):
        y = ssd.mamba2_ssd_chunked(x, bm, cm, loga, chunk=chunk)
        torch.testing.assert_close(y[0, 0, :, 0], want)
    torch.testing.assert_close(ssd.mamba2_ssd(x, bm, cm, loga)[0, 0, :, 0],
                               want)


def test_ssd_cost_at_the_zamba2_mixer_shape():
    """The numbers quoted in the kernel's header: 0.685 GB in f32 (0.2044
    ms at 3.35 TB/s) and 0.345 GB in bf16 (0.1030 ms), against 21.5 GFLOP,
    0.043 ms at the 495 TFLOP/s of TF32 that the kernel's products use: on
    the tensor cores bytes bound the function in both dtypes."""
    nbytes, flops = ssd.ssd_cost(4, 80, 4096, 64, 64, itemsize=4)
    nbytes16, flops16 = ssd.ssd_cost(4, 80, 4096, 64, 64, itemsize=2)
    assert round(nbytes / 1e9, 3) == 0.685
    assert round(nbytes16 / 1e9, 3) == 0.345
    assert round(flops / 1e9, 1) == 21.5 and flops16 == flops
    assert round(nbytes / 3.35e12 * 1e3, 4) == 0.2044
    assert round(nbytes16 / 3.35e12 * 1e3, 4) == 0.1030
    for n in (nbytes, nbytes16):
        assert flops / 495e12 < n / 3.35e12


def test_import_builds_nothing_and_cpu_tensors_take_the_plain_version():
    from repro_torch.kernels import build

    before, launches = build.BUILDS, ssd.LAUNCHES
    x, bm, cm, loga = map(_t, _inputs(1, 2, 9, 32, 16))
    assert torch.equal(ssd.mamba2_ssd(x, bm, cm, loga, chunk=4),
                       ssd.mamba2_ssd_ref(x, bm, cm, loga))
    assert build.BUILDS == before and ssd.LAUNCHES == launches


def _tf32_hi(x):
    """x's top 11 significant bits, rounded to nearest: the kernel's
    Veltkamp split (x * (2^13 + 1), then two f32 adds)."""
    g = x * 8193.0
    return g + (x - g)


def _tf32_trunc(x):
    """What an mma.sync TF32 operand keeps of an f32 register: its top 11
    significant bits (the low 13 mantissa bits ignored)."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _split(x, kind="tf32"):
    """x (f32) -> (hi, lo) as f32 values, as the products see them: in TF32
    as the kernel splits (hi rounded, lo = x - hi truncated by the mma), or
    in bf16 (the split the wkv kernel uses, kept to show why this kernel
    does not)."""
    if kind == "tf32":
        hi = _tf32_hi(x)
        return hi, _tf32_trunc(x - hi)
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _mm(a, b, a_exact, b_exact, kind):
    """a @ b as the kernel's mma.sync products take it: hi.hi + hi.lo +
    lo.hi over splits of both, without the lo of an exact side."""
    ah, al = (a, None) if a_exact else _split(a, kind)
    bh, bl = (b, None) if b_exact else _split(b, kind)
    out = ah @ bh
    if not b_exact:
        out = out + ah @ bl
    if not a_exact:
        out = out + al @ bh
    return out


def _tiled_mirror(x, bm, cm, loga, kind="tf32"):
    """The kernel's algorithm in plain torch on (B, nh, S, hd) x: returns y
    before its rounding to x's dtype, in f32. bf16 x/bm/cm are exact in
    TF32 and are not split; the state, the decayed scores and the decayed
    x are."""
    exact = x.dtype == torch.bfloat16
    B, nh, S, hd = x.shape
    sub = ssd.SUB
    n = -(-S // sub) * sub
    pad = lambda a: F.pad(a.float(), (0, 0, 0, n - S))
    xf, bf, cf = pad(x), pad(bm), pad(cm)
    la = F.pad(loga.float(), (0, n - S))  # padded steps: no decay, no input
    tri = torch.ones((sub, sub), dtype=torch.bool).tril()
    h = torch.zeros((B, nh, hd, bm.shape[-1]))
    y = torch.empty((B, nh, n, hd))
    for t0 in range(0, n, sub):
        sl = slice(t0, t0 + sub)
        xs, bs, cs = xf[:, :, sl], bf[:, None, sl], cf[:, None, sl]
        cum = la[:, :, sl].cumsum(-1)  # from the sub-chunk's start
        tot = cum[..., -1:]
        # scores C B^T, decayed by e^{cum_t - cum_s}, exponent masked s > t
        g = _mm(cs, bs.transpose(-1, -2), exact, exact, kind)
        g = g * (cum[..., :, None] - cum[..., None, :]).masked_fill(
            ~tri, float("-inf")).exp()
        # y^T (rows x tokens): e^{cum_t} h C^T + x^T G^T
        yt = _mm(h, cs.transpose(-1, -2), False, exact, kind) * \
            cum.exp()[..., None, :]
        yt = yt + _mm(xs.transpose(-1, -2), g.transpose(-1, -2), exact,
                      False, kind)
        y[:, :, sl] = yt.transpose(-1, -2)
        xd = xs * (tot - cum).exp()[..., None]
        h = h * tot.exp()[..., None] + _mm(xd.transpose(-1, -2), bs, False,
                                           exact, kind)
    return y[:, :, :S]


MIRROR_CASES = [
    # (B, nh, S, hd, ns): ragged S across staged chunks, S below one
    # sub-chunk, hd 64 with ns 64 and hd 128 with ns 32
    (2, 3, 100, 32, 16),
    (1, 2, 9, 32, 32),
    (1, 2, 150, 64, 64),
    (1, 1, 70, 128, 32),
]


@needs_reference
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("loga", ["drawn", 0.0, -80.0])
@pytest.mark.parametrize("case", MIRROR_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_tiled_mirror_of_the_kernel_matches_oracle_and_reference_kernel(
        case, loga, dtype):
    """The mirror (y before its rounding) against the sequential oracle and
    the Pallas kernel in interpret mode on the same inputs, at f32 2e-4:
    loga drawn as the model feeds it (down to ~-80 a step), 0 (no decay:
    the state sums every token) and -80 (each step all but wipes it).
    bf16 inputs: both references run on their exact f32 copies."""
    B, nh, S, hd, ns = case
    x, bm, cm, la = _inputs(B, nh, S, hd, ns, seed=S + hd, loga=loga)
    x, bm, cm = (_t(a, dtype) for a in (x, bm, cm))
    y = _tiled_mirror(x, bm, cm, _t(la))
    assert torch.isfinite(y).all()
    jin = (*(_j(_f32(a)) for a in (x, bm, cm)), _j(la))
    np.testing.assert_allclose(_f32(y), _f32(ref.mamba2_ssd_ref(*jin)),
                               **TOL["float32"])
    np.testing.assert_allclose(
        _f32(y), _f32(ref_ssd(*jin, chunk=64, interpret=True)),
        **TOL["float32"])


def test_tiled_mirror_with_bf16_splits_misses_the_f32_tolerance():
    """Why the kernel splits into TF32 and not bf16 (as the wkv kernel
    does): at hd 64, ns 128 over 300 tokens of tests/test_kernels.py's
    decays, bf16 hi + lo (~2^-17 a term) puts some outputs outside the f32
    rtol/atol 2e-4 of the sequential scan; TF32 hi + lo (~2^-21) stays well
    inside. The sequential plain version is the reference here (the oracle's
    arithmetic in torch)."""
    x, bm, cm, la = map(_t, _inputs(2, 4, 300, 64, 128, seed=1))
    want = _f32(ssd.mamba2_ssd_ref(x.double(), bm.double(), cm.double(),
                                   la.double()))
    excess = {}
    for kind in ("tf32", "bf16"):
        got = _f32(_tiled_mirror(x, bm, cm, la, kind=kind))
        excess[kind] = float(np.max(np.abs(got - want)
                                    / (2e-4 + 2e-4 * np.abs(want))))
    assert excess["tf32"] < 0.25 < 1.0 < excess["bf16"], excess


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("ns", ssd.STATE_DIMS)
@pytest.mark.parametrize("hd", ssd.HEAD_DIMS)
def test_launch_geometry_for_every_width(hd, ns, dtype):
    """Every (hd, ns) the wrapper takes: a block of 16 rows of h a warp
    (min(hd, 64) rows), the shared memory of the source's Geo (two stages
    of 32 tokens with padded rows, three per-token decay arrays, the scores
    of two 16-token sub-chunks as hi and lo, for f32 the lo parts of the
    staged C) within a block's limit and
    with every staged row 16-byte aligned, at least two blocks an SM; at
    the zamba2 mixer shape one wave of 320 blocks."""
    item = torch.empty((), dtype=dtype).element_size()
    geo = ssd.launch_geometry(4, 80, hd, ns, item)
    rows = min(hd, 64)
    ldx, ldb = rows + 16 // item, ns + 8
    assert geo["grid"] == (hd // rows, 80, 4)
    assert geo["blocks"] == 320 * (hd // rows)
    assert geo["warps"] == rows // 16 and geo["threads"] == 2 * rows
    stage = 32 * (ldx + 2 * ldb) * item + 32 * 4
    scores, c_lo = 2 * 2 * 16 * 24 * 4, (32 * ldb * 4 if item == 4 else 0)
    assert geo["smem"] == ssd.smem_bytes(hd, ns, item) == \
        2 * stage + 384 + scores + c_lo
    assert geo["smem"] <= kbuild.MAX_SMEM
    assert ldx * item % 16 == 0 and ldb * item % 16 == 0 and stage % 16 == 0
    assert geo["smem_blocks_per_sm"] >= 2
    assert geo["min_blocks_per_sm"] * geo["threads"] >= 256
    if (hd, ns) == (64, 64):
        assert geo["smem"] == (70_272 if item == 4 else 34_432)
        assert geo["min_blocks_per_sm"] == 3 <= geo["smem_blocks_per_sm"]
        assert geo["waves"] == pytest.approx(320 / 396) and geo["waves"] < 1


def test_launch_layout_takes_strided_views_and_refuses_misaligned_rows():
    """x as a (B, S, nh, hd) tensor seen as (B, nh, S, hd), bm and cm as
    halves of one (B, S, 2 ns) projection and loga at any stride launch;
    a misaligned base, a row stride that is not a multiple of 16 bytes or a
    non-contiguous last axis raise."""
    B, nh, S, hd, ns = 2, 3, 10, 32, 16
    x = torch.zeros((B, S, nh, hd)).transpose(1, 2)
    bc = torch.zeros((B, S, 2 * ns))
    bm, cm = bc[..., :ns], bc[..., ns:]
    la = torch.zeros((B, S, nh, 2))[..., 0].transpose(1, 2)
    st = ssd._launch_layout(x, bm, cm, la)
    assert st == (S * nh * hd, hd, nh * hd, 2 * S * ns, 2 * ns,
                  2 * S * ns, 2 * ns, 2 * S * nh, 2, 2 * nh)
    one = torch.zeros((1, 1, S, hd))
    assert ssd._launch_layout(one, bm[:1], cm[:1], la[:1, :1])[:3] == \
        (0, 0, hd)
    wide = torch.zeros((B, nh, S, hd + 1))
    with pytest.raises(ValueError, match="multiples of 4"):
        ssd._launch_layout(wide[..., :hd], bm, cm, la)
    shifted = torch.zeros(B * nh * S * hd + 1)[1:].view(B, nh, S, hd)
    with pytest.raises(ValueError, match="16-byte"):
        ssd._launch_layout(shifted, bm, cm, la)
    with pytest.raises(ValueError, match="contiguous"):
        ssd._launch_layout(x, bm.transpose(1, 2), cm, la)
    b16 = torch.zeros((B, S, 2 * ns + 4), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        ssd._launch_layout(x.bfloat16(), b16[..., :ns], b16[..., :ns], la)


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version_on_the_card():
    """Every case above plus wider ones, through the kernel on the card
    against the plain chunked version on the same tensors, in f32 and
    bf16; a strided x gives the same answer, and the staging tile does not
    change the result."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cases = SSD_CASES + [(2, 4, 300, 64, 128, 128), (1, 2, 90, 128, 32, 64)]
    for i, (B, nh, S, hd, ns, chunk) in enumerate(cases):
        for dtype in ("float32", "bfloat16"):
            x, bm, cm, loga = (_t(a).cuda() for a in _inputs(B, nh, S, hd, ns,
                                                             seed=i))
            dt = getattr(torch, dtype)
            x, bm, cm = x.to(dt), bm.to(dt), cm.to(dt)
            want = ssd.mamba2_ssd_chunked(x, bm, cm, loga, chunk=chunk)
            before = ssd.LAUNCHES
            y = ops.mamba2_ssd(x, bm, cm, loga, chunk=chunk)
            xs = x.transpose(1, 2).contiguous().transpose(1, 2)  # strided
            y2 = ssd.mamba2_ssd(xs, bm, cm, loga, chunk=5)
            torch.cuda.synchronize()
            assert ssd.LAUNCHES == before + 2 and y.dtype == dt
            np.testing.assert_allclose(_f32(y.cpu()), _f32(want.cpu()),
                                       **TOL[dtype])
            assert torch.equal(y, y2)


def _scan_f64(x, bm, cm, loga):
    """The sequential scan in float64 on the inputs' device: the exact
    reference where the f32 plain versions' own rounding is not small next
    to 2e-4 (the chunked form at chunk 128 misses it on drawn decays)."""
    x, bm, cm, loga = (a.double() for a in (x, bm, cm, loga))
    h = torch.zeros((*x.shape[:2], x.shape[-1], bm.shape[-1]),
                    dtype=torch.float64, device=x.device)
    ys = []
    for t in range(x.shape[2]):
        h = h * loga[:, :, t].exp()[..., None, None] + \
            x[:, :, t, :, None] * bm[:, None, t, None, :]
        ys.append((h * cm[:, None, t, None, :]).sum(-1))
    return torch.stack(ys, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("loga", [-80.0, 0.0, "drawn"])
def test_cuda_kernel_at_extreme_decays_and_strided_bf16_on_the_card(loga):
    """loga at -80 a step (every exp underflows), at 0 (the state sums all
    300 tokens) and drawn as mamba2_mix feeds it: f32 finite and within the
    f32 tolerance of the scan in float64; then bf16 with x as a (B, S, nh,
    hd) view, bm and cm as halves of one projection and loga strided,
    against the plain chunked version on contiguous copies."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    B, nh, S, hd, ns = 2, 4, 300, 64, 64
    x, bm, cm, la = (_t(a).cuda() for a in _inputs(B, nh, S, hd, ns, seed=7,
                                                     loga=loga))
    y = ssd.mamba2_ssd(x, bm, cm, la)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all()
    np.testing.assert_allclose(_f32(y.cpu()), _scan_f64(x, bm, cm, la).cpu()
                               .numpy(), **TOL["float32"])
    bf = torch.bfloat16
    xs = x.to(bf).transpose(1, 2).contiguous().transpose(1, 2)
    bc = torch.cat([bm, cm], -1).to(bf)
    las = la.transpose(1, 2).contiguous().transpose(1, 2)
    y16 = ssd.mamba2_ssd(xs, bc[..., :ns], bc[..., ns:], las)
    want16 = ssd.mamba2_ssd_chunked(x.to(bf), bm.to(bf), cm.to(bf), la)
    torch.cuda.synchronize()
    assert y16.dtype == bf and torch.isfinite(y16.float()).all()
    np.testing.assert_allclose(_f32(y16.cpu()), _f32(want16.cpu()),
                               **TOL["bfloat16"])
