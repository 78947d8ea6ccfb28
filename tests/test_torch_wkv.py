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

The ``gpu`` test needs neither jax nor the reference, so it runs where only
the port is installed:
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_wkv.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

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


def test_wkv_cost_at_the_rwkv6_7b_train_shape():
    """The numbers quoted in the kernel's header: 0.81 GB (~0.24 ms at
    3.35 TB/s) against 17.2 GFLOP (~0.26 ms at 67 TFLOP/s)."""
    nbytes, flops = wkv.wkv_cost(4, 64, 4096, 64, itemsize=2)
    assert round(nbytes / 1e9, 2) == 0.81
    assert round(flops / 1e9, 1) == 17.2
    assert flops / 67e12 > nbytes / 3.35e12
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
    views; the staging tile does not change the result."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cases = [c[:4] for c in WKV_CASES] + [(2, 4, 300, 64), (1, 2, 50, 128)]
    for i, (B, H, S, hd) in enumerate(cases):
        r, k, v, logw, u = (_t(a).cuda() for a in _inputs(
            B, H, S, hd, seed=i, layout="bshd", logw_range="clip"))
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
