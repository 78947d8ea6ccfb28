"""``repro_torch.models`` (hybrid family, zamba2: Mamba2 layers and a shared
attention block) against ``repro.models`` on the same weights and inputs.

The reference's parameter tree is carried into the port by
``load_reference_params``, with the norm scales, the convolutions' biases
and ``dt_bias`` / ``D`` perturbed from a seed (the reference initialises
them to 1, 0, 0 and 1). Everything runs in f32 on the CPU. Tolerances:
- the depthwise convolution: rtol/atol 1e-6 (four products and a sum in
  the same order);
- ``mamba2_mix``, a Mamba2 layer: 2e-5 (the chunked scan sums its
  einsums' terms in another order than XLA);
- ``forward_train``: loss rtol 1e-5, each gradient leaf within
  1e-5 · (1 + max |g|) of ``jax.value_and_grad``'s, as
  tests/test_torch_train.py holds the dense and ssm families;
- the SSD kernel's plain version (``ops.mamba2_ssd`` on CPU tensors, the
  sequential recurrence) against ``mamba2_mix``'s own chunked scan on the
  same Δ-scaled inputs: y scaled by max(1, max |y|) within 2e-5, at the
  reduced shape and at one zamba2-2.7b head shape (hd 64, state 64). The
  two agree, so wiring the kernel into the mixer would change the
  implementation only.

The full-width check builds the port's zamba2-2.7b tree on the ``meta``
device and compares every leaf's shape with ``jax.eval_shape`` of the
reference's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.data.synthetic import make_batch as ref_make_batch  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.utils import tree_leaves, tree_map  # noqa: E402

CONV_TOL = dict(rtol=1e-6, atol=1e-6)
MIX_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = 1e-5
LOSS_RTOL = 1e-5
SSD_TOL = 2e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**over):
    """The reduced zamba2 config in both packages (equal field for field),
    with ``over`` applied to each."""
    r = ref_configs.reduce_config(ref_configs.get("zamba2_2p7b"), **over)
    p = configs.reduce_config(configs.get("zamba2_2p7b"), **over)
    assert dataclasses.asdict(r) == dataclasses.asdict(p)
    return r, p


def _ref_tree(cfg_r, seed=0):
    """The reference's init, as numpy, with its constant leaves replaced by
    seeded values around them."""
    tree = jax.tree.map(np.asarray,
                        rlm.init_params(cfg_r, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        key = path[-1].key if hasattr(path[-1], "key") else ""
        if key in ("scale", "D"):
            return (1 + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        if key in ("conv_x_b", "conv_B_b", "conv_C_b", "dt_bias"):
            return (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(perturb, tree)


def _x(shape, seed=2):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, tol, label=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), err_msg=label,
                               **tol)


def _mamba_state(cfg, B, seed):
    """A non-zero Mamba2 decode state in both frameworks."""
    rng = np.random.default_rng(seed)
    d_in = cfg.ssm_expand * cfg.d_model
    nh, hd, ns = d_in // cfg.ssm_head_dim, cfg.ssm_head_dim, cfg.ssm_state
    st = {"conv_x": rng.standard_normal((B, 3, d_in)),
          "conv_B": rng.standard_normal((B, 3, ns)),
          "conv_C": rng.standard_normal((B, 3, ns)),
          "ssm": rng.standard_normal((B, nh, hd, ns))}
    st = {k: v.astype(np.float32) for k, v in st.items()}
    return ({k: jnp.asarray(v) for k, v in st.items()},
            {k: torch.from_numpy(v) for k, v in st.items()})


@pytest.mark.parametrize("with_state", [False, True])
def test_depthwise_conv_matches_reference(with_state):
    x, w, b = _x((2, 9, 24), 1), _x((4, 24), 2), _x((24,), 3)
    st = _x((2, 3, 24), 4) if with_state else None
    yj, sj = RL._depthwise_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                None if st is None else jnp.asarray(st))
    yt, s_t = L._depthwise_conv(torch.from_numpy(x), torch.from_numpy(w),
                                torch.from_numpy(b),
                                None if st is None else torch.from_numpy(st))
    _close(yt, yj, CONV_TOL, "y")
    _close(s_t, sj, CONV_TOL, "state")
    assert tuple(s_t.shape) == (2, 3, 24)


@pytest.mark.parametrize("S", [1, 37, 128])
def test_mamba2_mix_chunked_matches_reference(S):
    """The full-sequence path with return_state: S below, not a multiple
    of and equal to twice the chunk (16 here, 64 by default)."""
    cfg_r, cfg_p = _cfgs()
    p_np = _ref_tree(cfg_r)["layers"][1]["mamba"]
    pj = jax.tree.map(jnp.asarray, p_np)
    pt = tree_map(lambda a: torch.from_numpy(np.array(a)), p_np)
    x = _x((2, S, cfg_r.d_model), 5)
    yj, sj = RL.mamba2_mix(pj, cfg_r, jnp.asarray(x), chunk=16,
                           return_state=True)
    yt, st = L.mamba2_mix(pt, cfg_p, torch.from_numpy(x), chunk=16,
                          return_state=True)
    _close(yt, yj, MIX_TOL, "y")
    assert sorted(st) == sorted(sj)
    for k in st:
        assert st[k].dtype == torch.float32
        _close(st[k], sj[k], MIX_TOL, k)
    y0, s0 = L.mamba2_mix(pt, cfg_p, torch.from_numpy(x), chunk=16)
    assert s0 is None and torch.equal(y0, yt)


def test_mamba2_mix_decode_branch_matches_reference():
    cfg_r, cfg_p = _cfgs()
    p_np = _ref_tree(cfg_r)["layers"][2]["mamba"]
    pj = jax.tree.map(jnp.asarray, p_np)
    pt = tree_map(lambda a: torch.from_numpy(np.array(a)), p_np)
    sj, st = _mamba_state(cfg_r, 3, 6)
    for step in range(3):
        x = _x((3, 1, cfg_r.d_model), 7 + step)
        yj, sj = RL.mamba2_mix(pj, cfg_r, jnp.asarray(x), state=sj)
        yt, st = L.mamba2_mix(pt, cfg_p, torch.from_numpy(x), state=st)
        _close(yt, yj, MIX_TOL, f"y step {step}")
        for k in st:
            _close(st[k], sj[k], MIX_TOL, f"{k} step {step}")


@pytest.mark.parametrize("shape", ["reduced", "zamba2_head"])
def test_ssd_kernel_plain_version_agrees_with_mamba2_mix_scan(shape):
    """y before the D skip: ``mamba2_mix``'s chunked scan (chunk 64) and the
    SSD kernel's wrapper (its plain version on CPU tensors) on the same
    inputs, prepared as ``mamba2_mix`` prepares them (Δ = softplus(dt +
    dt_bias), loga = Δ·A with A = -exp(A_log), x scaled by Δ)."""
    B, S, nh, hd, ns = ((2, 100, 8, 32, 16) if shape == "reduced"
                        else (1, 150, 4, 64, 64))
    rng = np.random.default_rng(8)
    dt = torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((B, S, nh)).astype(np.float32) - 1.0))
    A = -torch.arange(1, nh + 1, dtype=torch.float32)
    x = torch.from_numpy(rng.standard_normal((B, S, nh, hd)).astype(np.float32))
    Bm = torch.from_numpy(rng.standard_normal((B, S, ns)).astype(np.float32))
    Cm = torch.from_numpy(rng.standard_normal((B, S, ns)).astype(np.float32))
    xdt, loga = x * dt[..., None], dt * A
    y_mix, _ = L._ssd_scan(xdt, Bm, Cm, loga, 64)
    y_ssd = ops.mamba2_ssd(xdt.transpose(1, 2), Bm, Cm,
                           loga.transpose(1, 2)).transpose(1, 2)
    scale = max(1.0, float(y_mix.abs().max()))
    err = float((y_ssd - y_mix).abs().max()) / scale
    assert err < SSD_TOL, err


def _ref_loss_and_grads(cfg_r, tree, b):
    fn = jax.jit(jax.value_and_grad(
        lambda p, bb: rlm.forward_train(p, cfg_r, bb), has_aux=True))
    (loss, _), g = fn(jax.tree.map(jnp.asarray, tree), b)
    return float(loss), g


@pytest.mark.parametrize("remat,stacked", [("none", False), ("full", True)])
def test_forward_train_loss_and_gradients_match_value_and_grad(remat, stacked):
    cfg_r, cfg_p = _cfgs(remat=remat, scan_layers=stacked)
    tree = _ref_tree(cfg_r)
    b = {k: np.asarray(v) for k, v in
         ref_make_batch(cfg_r, 2, 40, seed=1).items()}
    loss_r, g_r = _ref_loss_and_grads(cfg_r, tree, b)
    params = lm.load_reference_params(tree, cfg_p, device="cpu")
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss_p, _ = lm.forward_train(leaves, cfg_p, {k: torch.from_numpy(v.copy())
                                                for k, v in b.items()})
    g_p = torch.autograd.grad(loss_p, tree_leaves(leaves))
    assert abs(float(loss_p.detach()) - loss_r) <= LOSS_RTOL * abs(loss_r)
    want = tree_leaves(lm.load_reference_params(
        jax.tree.map(np.asarray, g_r), cfg_p, device="cpu"))
    assert len(want) == len(g_p)
    for g, w in zip(g_p, want):
        assert g.shape == w.shape and torch.isfinite(g).all()
        err = float((g - w).abs().max()) / (1.0 + float(w.abs().max()))
        assert err < GRAD_TOL, err
    # the shared block is one weight set, called num_layers / period times
    assert float(leaves["shared_block"]["attn"]["wq"].abs().sum()) > 0


def test_hybrid_periods_and_shared_block_order():
    """Stacked layers walk per Mamba2 layers then the shared block, n_per
    times; listed layers call it after every hybrid_period-th layer."""
    cfg = configs.get("zamba2_2p7b")
    assert lm._hybrid_periods(cfg) == (6, 9)
    after = [i for i in range(cfg.num_layers) if lm._shared_after(cfg, i)]
    assert after == list(range(5, 54, 6))
    listed = dataclasses.replace(cfg, scan_layers=False)
    assert [i for i in range(54) if lm._shared_after(listed, i)] == after
    # no period: the stacked walk runs the block once at the end, the
    # listed walk never (as the reference's two paths do)
    flat = dataclasses.replace(cfg, hybrid_period=0)
    assert [i for i in range(54) if lm._shared_after(flat, i)] == [53]
    assert not any(lm._shared_after(dataclasses.replace(
        flat, scan_layers=False), i) for i in range(54))


def test_init_decode_state_has_the_reference_shapes():
    cfg_r, cfg_p = _cfgs()
    want = rlm.init_decode_state(cfg_r, 3, 20)
    got = lm.init_decode_state(cfg_p, 3, 20, device="cpu")
    assert got.kv_k.shape == want.kv_k.shape == (2, 3, 20, 2, 32)
    assert sorted(got.ssm) == sorted(want.ssm)
    for k in got.ssm:
        assert tuple(got.ssm[k].shape) == want.ssm[k].shape
        assert got.ssm[k].dtype == torch.float32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            lm.init_decode_state(cfg_p, 2, 16)


def test_full_width_zamba2_tree_has_the_reference_shapes():
    cfg_r, cfg_p = ref_configs.get("zamba2_2p7b"), configs.get("zamba2_2p7b")
    assert cfg_p.scan_layers and (cfg_p.num_layers, cfg_p.d_model,
                                  cfg_p.hybrid_period) == (54, 2560, 6)
    want = jax.eval_shape(lambda: rlm.init_params(cfg_r, jax.random.PRNGKey(0)))
    got = lm.init_params(cfg_p, None, device="meta")
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (path, w), (_, g) in zip(flat_w, flat_g):
        assert tuple(g.shape) == w.shape, jax.tree_util.keystr(path)
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
    n = sum(int(np.prod(w.shape)) for _, w in flat_w)
    assert n == sum(t.numel() for t in tree_leaves(got))
