"""``repro_torch.kernels.mamba2_ssd`` and ``ops.mamba2_ssd`` against the
reference on identical numpy inputs; and (on a card) the CUDA kernel
against its plain versions.

On a CPU tensor the wrapper runs its plain version, the sequential scan.
Tolerances are those of tests/test_kernels.py: f32 rtol/atol 2e-4 (a
chunked form and the sequential scan sum in other orders), bf16 3e-2 (the
output is rounded to bf16 on both sides).

The ``gpu`` test needs neither jax nor the reference, so it runs where only
the port is installed:
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_ssd.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

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


def _inputs(B, nh, S, hd, ns, seed=0):
    """x, bm, cm ~ N(0, 1); loga = -softplus(N(0, 1)) <= 0, as
    tests/test_kernels.py draws them. numpy f32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, nh, S, hd)).astype(np.float32)
    bm = rng.standard_normal((B, S, ns)).astype(np.float32)
    cm = rng.standard_normal((B, S, ns)).astype(np.float32)
    loga = -np.logaddexp(0.0, rng.standard_normal((B, nh, S)))
    return x, bm, cm, loga.astype(np.float32)


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
    """The numbers quoted in the kernel's header: 0.69 GB (~0.20 ms at
    3.35 TB/s) against 21.5 GFLOP (~0.32 ms at 67 TFLOP/s)."""
    nbytes, flops = ssd.ssd_cost(4, 80, 4096, 64, 64, itemsize=4)
    assert round(nbytes / 1e9, 3) == 0.685
    assert round(flops / 1e9, 1) == 21.5
    assert flops / 67e12 > nbytes / 3.35e12


def test_import_builds_nothing_and_cpu_tensors_take_the_plain_version():
    from repro_torch.kernels import build

    before, launches = build.BUILDS, ssd.LAUNCHES
    x, bm, cm, loga = map(_t, _inputs(1, 2, 9, 32, 16))
    assert torch.equal(ssd.mamba2_ssd(x, bm, cm, loga, chunk=4),
                       ssd.mamba2_ssd_ref(x, bm, cm, loga))
    assert build.BUILDS == before and ssd.LAUNCHES == launches


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
