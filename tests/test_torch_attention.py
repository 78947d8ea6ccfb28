"""``repro_torch.kernels.flash_attention`` and the port's attention against
the reference, on identical numpy inputs; and (on a card) the CUDA kernel
against its plain version.

Tolerances are those of tests/test_kernels.py: f32 rtol/atol 2e-5 (the
online softmax and the full softmax sum in other orders), bf16 3e-2 (the
output is rounded to bf16 on both sides, and one bf16 ulp at 1.0 is 7.8e-3).
The bf16 inputs are the same bits on both sides: f32 numpy values rounded to
nearest even by each framework.

The ``gpu`` test needs neither jax nor the reference, so it runs where only
the port is installed:
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_attention.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

try:  # the reference; absent where only the port is installed
    import jax.numpy as jnp
    from repro.kernels import ops as ref_ops
    from repro.kernels import ref
    from repro.kernels.flash_attention import flash_attention_bhsd as ref_fa
    from repro.models import layers as RL
except ImportError:  # pragma: no cover - a port-only install
    jnp = ref_ops = ref = ref_fa = RL = None

needs_reference = pytest.mark.skipif(ref is None,
                                     reason="needs jax and the reference")

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}

ATTN_CASES = [
    # (B, Hq, Hkv, Sq, Skv, hd, causal, bq, bk): tests/test_kernels.py:35
    (1, 2, 2, 128, 128, 64, True, 64, 64),
    (2, 4, 2, 96, 96, 32, True, 64, 64),      # GQA + ragged seq vs block
    (1, 8, 1, 64, 64, 64, True, 32, 32),      # MQA
    (2, 2, 2, 57, 57, 32, True, 32, 32),      # non-multiple seq (padding path)
    (1, 2, 2, 64, 64, 32, False, 32, 32),     # non-causal (encoder)
    (1, 4, 4, 32, 160, 32, True, 32, 64),     # decode-ish: Sq << Skv w/ offset
    # group 7 (Qwen2-7B's 28 over 4), hd 128, ragged
    (1, 7, 1, 40, 40, 128, True, 32, 32),
    (1, 14, 2, 24, 24, 64, True, 32, 32),
]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _pair(a: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor of ``dtype``."""
    return (jnp.asarray(a).astype(getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _qkv(B, Hq, Hkv, Sq, Skv, hd, dtype, seed=0):
    q = _pair(_np((B, Hq, Sq, hd), seed), dtype)
    k = _pair(_np((B, Hkv, Skv, hd), seed + 1), dtype)
    v = _pair(_np((B, Hkv, Skv, hd), seed + 2), dtype)
    return q, k, v


@needs_reference
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: "x".join(map(str, c[:6])) + ("c" if c[6] else "f"))
def test_plain_version_matches_reference_kernel_and_oracle(case, dtype):
    B, Hq, Hkv, Sq, Skv, hd, causal, bq, bk = case
    (qj, qt), (kj, kt), (vj, vt) = _qkv(B, Hq, Hkv, Sq, Skv, hd, dtype)
    off = Skv - Sq if Sq < Skv else 0
    got = fa.flash_attention_bhsd(qt, kt, vt, causal=causal, q_offset=off)
    assert got.dtype == qt.dtype and tuple(got.shape) == (B, Hq, Sq, hd)
    kern = ref_fa(qj, kj, vj, causal=causal, q_offset=off, block_q=bq,
                  block_k=bk, interpret=True)
    oracle = ref.attention_ref(qj, kj, vj, causal=causal, q_offset=off)
    np.testing.assert_allclose(_f32(got), _f32(kern), **TOL[dtype])
    np.testing.assert_allclose(_f32(got), _f32(oracle), **TOL[dtype])


@needs_reference
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_layout_wrapper_matches_reference(dtype):
    q = _pair(_np((2, 40, 7, 32), 3), dtype)  # (B,S,H,hd)
    k = _pair(_np((2, 40, 1, 32), 4), dtype)
    v = _pair(_np((2, 40, 1, 32), 5), dtype)
    got = ops.flash_attention(q[1], k[1], v[1], causal=True)
    want = ref_ops.flash_attention(q[0], k[0], v[0], causal=True,
                                   block_q=32, block_k=32)
    assert tuple(got.shape) == (2, 40, 7, 32)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])


CORE_CASES = [
    # (B, S, Skv, nq, nkv, hd, causal, q_offset, chunk)
    (2, 24, 24, 4, 2, 32, True, 0, 16),
    (1, 16, 40, 7, 1, 32, True, 24, 16),     # offset, group 7, ragged chunk
    (2, 20, 20, 28, 4, 64, False, 0, 8),     # full attention
]


@needs_reference
@pytest.mark.parametrize("impl", ["chunked", "naive", "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CORE_CASES, ids=lambda c: "x".join(map(str, c)))
def test_attention_core_matches_reference(case, dtype, impl):
    B, S, Skv, nq, nkv, hd, causal, off, chunk = case
    q = _pair(_np((B, S, nq, hd), 6), dtype)
    k = _pair(_np((B, Skv, nkv, hd), 7), dtype)
    v = _pair(_np((B, Skv, nkv, hd), 8), dtype)
    got = L.attention_core(q[1], k[1], v[1], causal=causal, chunk=chunk,
                           q_offset=off, impl=impl)
    want = RL.attention_core(q[0], k[0], v[0], causal=causal, chunk=chunk,
                             q_offset=off, impl=impl)
    assert got.dtype == q[1].dtype and tuple(got.shape) == (B, S, nq, hd)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])


@pytest.mark.parametrize("causal,off", [(True, 0), (True, 64), (False, 0)])
def test_attention_cost_counts_unmasked_pairs(causal, off):
    B, Hq, Hkv, Sq, Skv, hd = 2, 28, 4, 16, 80 if off else 16, 128
    nbytes, flops = fa.attention_cost(B, Hq, Hkv, Sq, Skv, hd, causal=causal,
                                      q_offset=off, itemsize=2)
    qpos = np.arange(Sq)[:, None] + off
    mask = (qpos >= np.arange(Skv)[None, :]) if causal else np.ones((Sq, Skv))
    assert flops == 4 * hd * int(mask.sum()) * B * Hq
    assert nbytes == 2 * hd * B * (2 * Hq * Sq + 2 * Hkv * Skv)


def test_serve_shape_bound_is_memory():
    """The serve shape's numbers quoted in the kernel's header: 33.6 MB
    (~10 us at 3.35 TB/s) against ~0.95 GFLOP (~1 us at 989 TFLOP/s)."""
    nbytes, flops = fa.attention_cost(32, 28, 4, 64, 64, 128, causal=True,
                                      q_offset=0, itemsize=2)
    assert round(nbytes / 1e6, 1) == 33.6
    assert round(flops / 1e9, 2) == 0.95
    assert nbytes / 3.35e12 > flops / 989e12


def test_import_builds_nothing_and_cpu_tensors_take_the_plain_version():
    from repro_torch.kernels import build

    before, launches = build.BUILDS, fa.LAUNCHES
    q = torch.from_numpy(_np((1, 2, 8, 32), 9))
    out = fa.flash_attention_bhsd(q, q, q)
    np.testing.assert_array_equal(out.numpy(),
                                  fa.flash_attention_bhsd_ref(q, q, q).numpy())
    assert build.BUILDS == before and fa.LAUNCHES == launches


def _model_layout(B, S, Hq, Hkv, hd, dtype, d_model=64, seed=10):
    """q, k, v as the model hands them to the kernel: ``_project_qkv``'s
    (B, S, H, hd) tensors seen as (B, H, S, hd) views (``ops.flash_attention``
    transposes them without a copy)."""
    from types import SimpleNamespace

    rng = np.random.default_rng(seed)
    w = lambda n: torch.from_numpy(rng.standard_normal((d_model, n))
                                   .astype(np.float32)).to(dtype)
    p = {"wq": w(Hq * hd), "wk": w(Hkv * hd), "wv": w(Hkv * hd)}
    cfg = SimpleNamespace(resolved_head_dim=hd, num_heads=Hq,
                          num_kv_heads=Hkv)
    x = torch.from_numpy(rng.standard_normal((B, S, d_model))
                         .astype(np.float32)).to(dtype)
    q, k, v = L._project_qkv(p, cfg, x, x)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


@pytest.mark.parametrize("B,S,Hq,Hkv,hd,dtype", [
    (2, 16, 28, 4, 128, torch.bfloat16),   # Qwen2-7B's heads
    (2, 1, 28, 4, 128, torch.bfloat16),    # one position (decode)
    (3, 9, 9, 3, 64, torch.float32),       # SmolLM's heads
    (1, 5, 8, 8, 32, torch.bfloat16),      # group 1
])
def test_launch_layout_takes_the_model_layout_views(B, S, Hq, Hkv, hd, dtype):
    q, k, v = _model_layout(B, S, Hq, Hkv, hd, dtype)
    assert q.stride() == (S * Hq * hd, hd, Hq * hd, 1)  # the model layout
    passed = lambda *xs: tuple(s if n > 1 else 0 for x in xs
                               for n, s in zip(x.shape[:3], x.stride()[:3]))
    # the (b, h, s) strides of each view; a size-1 axis is passed as 0
    assert fa._launch_layout(q, k, v, 0) == passed(q, k, v)
    # contiguous (B, H, S, hd) tensors are taken as they are
    qc, kc, vc = (x.contiguous() for x in (q, k, v))
    assert fa._launch_layout(qc, kc, vc, 3) == passed(qc, kc, vc)


def _bad_layouts():
    bf = torch.bfloat16
    z = lambda *shape, dtype=bf: torch.zeros(shape, dtype=dtype)
    q, k, v = z(2, 8, 16, 64), z(2, 2, 16, 64), z(2, 2, 16, 64)
    unaligned = torch.zeros(2 * 8 * 16 * 64 + 1, dtype=bf)[1:].view(2, 8, 16,
                                                                      64)
    return {
        "3-D": ((q[0], k, v, 0), ValueError, "4-D"),
        "shapes": ((q, k, z(2, 2, 17, 64), 0), ValueError, "do not agree"),
        "heads": ((z(2, 7, 16, 64), k, v, 0), ValueError, "kv heads"),
        "hd not instantiated": ((z(2, 8, 16, 96), z(2, 2, 16, 96),
                                 z(2, 2, 16, 96), 0), ValueError, "head_dim"),
        "float16": ((q.half(), k.half(), v.half(), 0), TypeError, "dtypes"),
        "mixed dtypes": ((q, k.float(), v, 0), TypeError, "dtypes"),
        "devices": ((q, k.to("meta"), v, 0), ValueError, "devices"),
        "q_offset": ((q, k, v, -1), ValueError, "q_offset"),
        "hd strided": ((z(2, 8, 64, 16).transpose(2, 3), k, v, 0), ValueError,
                       "contiguous axis"),
        "row stride": ((z(2, 16, 8, 68)[..., :64].transpose(1, 2), k, v, 0),
                       ValueError, "multiples of 8"),
        "base pointer": ((unaligned, k, v, 0), ValueError, "16-byte"),
    }


@pytest.mark.parametrize("case", list(_bad_layouts()))
def test_launch_layout_refuses_what_the_kernel_cannot_take(case):
    args, exc, words = _bad_layouts()[case]
    with pytest.raises(exc, match=words):
        fa._launch_layout(*args)


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version_on_the_card():
    """Every case above, plus the serve shape and the bf16 path's edge cases
    (group 1 and 8, packed tiles that straddle positions, Sq=1 decode, many
    key tiles, full attention), each also as strided (model-layout) views,
    through the kernel on the card against the plain version on the same
    tensors."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cases = [(*c[:7], max(c[4] - c[3], 0)) for c in ATTN_CASES]
    cases += [
        # (B, Hq, Hkv, Sq, Skv, hd, causal, q_offset)
        (4, 28, 4, 64, 64, 128, True, 0),      # the serve shape
        (2, 8, 8, 64, 64, 128, True, 0),       # group 1 (MHA)
        (2, 32, 4, 48, 48, 64, True, 0),       # group 8
        (2, 28, 4, 40, 40, 128, True, 0),      # group 7, tiles straddle pos
        (3, 28, 4, 1, 512, 128, True, 511),    # Sq=1 decode
        (1, 28, 4, 2048, 2048, 128, True, 0),  # many key tiles, two buffers
        (2, 28, 4, 100, 300, 128, False, 0),   # full attention, ragged tiles
    ]
    for B, Hq, Hkv, Sq, Skv, hd, causal, off in cases:
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            q = torch.from_numpy(_np((B, Hq, Sq, hd), 0)).to("cuda", dt)
            k = torch.from_numpy(_np((B, Hkv, Skv, hd), 1)).to("cuda", dt)
            v = torch.from_numpy(_np((B, Hkv, Skv, hd), 2)).to("cuda", dt)
            before = fa.LAUNCHES
            got = fa.flash_attention_bhsd(q, k, v, causal=causal, q_offset=off)
            want = fa.flash_attention_bhsd_ref(q, k, v, causal=causal,
                                               q_offset=off)
            torch.cuda.synchronize()
            assert fa.LAUNCHES == before + 1
            np.testing.assert_allclose(_f32(got.cpu()), _f32(want.cpu()),
                                       **TOL[dtype])
            # the model layout: strided (B,H,S,hd) views of (B,S,H,hd)
            qm, km, vm = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            got = ops.flash_attention(qm, km, vm, causal=causal, q_offset=off)
            np.testing.assert_allclose(_f32(got.transpose(1, 2).cpu()),
                                       _f32(want.cpu()), **TOL[dtype])
