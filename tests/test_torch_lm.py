"""``repro_torch.models`` (dense family) against ``repro.models`` on the same
weights and inputs.

The reference's parameter tree (random biases and norm scales, so the QKV
bias and the norms are exercised) is carried into the port by
``load_reference_params``. Everything runs in f32 on the CPU. Tolerance:
rtol/atol 1e-4 through the whole reduced model (four layers and the head;
the two frameworks sum the matmuls and the softmax in other orders, ~1e-6
relative a layer, and the logits' scale is ~1); 2e-5 for the single layers.

The full-width checks build the port's Qwen2-7B tree, and every full
config's (all ten architectures), on the ``meta`` device and compare every
leaf's shape and dtype with ``jax.eval_shape`` of the reference's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
LAYER_TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(name, **over):
    """The reduced config of ``name`` in both packages (equal field for
    field), with ``over`` applied to each."""
    r = ref_configs.reduce_config(ref_configs.get(name), **over)
    p = configs.reduce_config(configs.get(name), **over)
    assert dataclasses.asdict(r) == dataclasses.asdict(p)
    return r, p


CASES = {
    "qwen2": dict(name="qwen2_7b"),                        # QKV bias, GQA 4:2
    "smollm": dict(name="smollm_135m"),                    # tied embeddings
    "group7": dict(name="qwen2_7b", num_heads=7, num_kv_heads=1),
    "qwen2_stacked": dict(name="qwen2_7b", scan_layers=True),
}


def _ref_tree(cfg_r, seed=0):
    """The reference's init, as numpy, with the zero biases and unit norm
    scales replaced by random values."""
    tree = jax.tree.map(np.asarray,
                        rlm.init_params(cfg_r, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        key = path[-1].key if hasattr(path[-1], "key") else ""
        if key in ("bq", "bk", "bv"):
            return (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        if key == "scale":
            return (1 + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(perturb, tree)


def _models(case):
    kw = dict(CASES[case])
    cfg_r, cfg_p = _cfgs(kw.pop("name"), **kw)
    tree = _ref_tree(cfg_r)
    return cfg_r, cfg_p, jax.tree.map(jnp.asarray, tree), \
        lm.load_reference_params(tree, cfg_p, device="cpu")


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(
        1, cfg.vocab_size, (B, S)).astype(np.int32)


def _x(shape, seed=2):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, tol=TOL, label=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), err_msg=label,
                               **tol)


def test_rmsnorm_and_rope_match_reference():
    x = _x((2, 12, 4, 32))
    scale = 1 + 0.1 * _x((32,), 3)
    _close(L.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x),
                     1e-5),
           RL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-5),
           LAYER_TOL)
    pos = np.arange(7, 19)
    for theta in (10_000.0, 1_000_000.0):
        _close(L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
               RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta),
               LAYER_TOL, f"rope theta={theta}")
    # bf16 in, computed in f32, cast back: one rounding on each side
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = L.apply_rope(xb, torch.from_numpy(pos), 1e6)
    want = RL.apply_rope(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(pos), 1e6)
    assert got.dtype == torch.bfloat16
    _close(got, want, dict(rtol=1e-2, atol=1e-2), "rope bf16")


@pytest.mark.parametrize("case", ["qwen2", "smollm", "group7"])
def test_mlp_and_attention_apply_match_reference(case):
    cfg_r, cfg_p, pj, pt = _models(case)
    x = _x((2, 20, cfg_r.d_model), 4)
    lj, lt = pj["layers"][1], pt["layers"][1]
    _close(L.mlp_apply(lt["mlp"], cfg_p, torch.from_numpy(x)),
           RL.mlp_apply(lj["mlp"], cfg_r, jnp.asarray(x)), LAYER_TOL, "mlp")
    for impl in ("chunked", "naive", "pallas"):
        cr = dataclasses.replace(cfg_r, attn_impl=impl, attn_chunk=8)
        cp = dataclasses.replace(cfg_p, attn_impl=impl, attn_chunk=8)
        _close(L.attention_apply(lt["attn"], cp, torch.from_numpy(x)),
               RL.attention_apply(lj["attn"], cr, jnp.asarray(x)), LAYER_TOL,
               f"attention {impl}")
    # cross-attention keeps the chunked path even when pallas is selected
    kv = _x((2, 9, cfg_r.d_model), 5)
    cr = dataclasses.replace(cfg_r, attn_impl="pallas")
    cp = dataclasses.replace(cfg_p, attn_impl="pallas")
    _close(L.attention_apply(lt["attn"], cp, torch.from_numpy(x),
                             kv_src=torch.from_numpy(kv)),
           RL.attention_apply(lj["attn"], cr, jnp.asarray(x),
                              kv_src=jnp.asarray(kv)), LAYER_TOL, "cross")


@pytest.mark.parametrize("case", list(CASES))
def test_forward_prefill_matches_reference(case):
    cfg_r, cfg_p, pj, pt = _models(case)
    B, S, max_seq = 3, 21, 32
    toks = _tokens(cfg_r, B, S)
    for impl in ("chunked", "pallas"):
        cr = dataclasses.replace(cfg_r, attn_impl=impl, attn_chunk=8)
        cp = dataclasses.replace(cfg_p, attn_impl=impl, attn_chunk=8)
        lj, sj = rlm.forward_prefill(pj, cr, {"tokens": jnp.asarray(toks)},
                                     max_seq=max_seq)
        lt, st = lm.forward_prefill(pt, cp, {"tokens": torch.from_numpy(toks)},
                                    max_seq=max_seq)
        assert tuple(lt.shape) == (B, 1, cfg_r.vocab_size)
        _close(lt, lj, TOL, f"{case} {impl} logits")
        for name in ("kv_k", "kv_v"):
            a, b = getattr(st, name), getattr(sj, name)
            assert tuple(a.shape) == b.shape and a.dtype == torch.float32
            _close(a, b, TOL, f"{case} {impl} {name}")
        assert int(st.pos) == int(sj.pos) == S
        # the serve step's lean path gives the same logits
        _close(lm.score_last(pt, cp, torch.from_numpy(toks)), lj, TOL,
               f"{case} {impl} score_last")


def test_vocab_true_masks_padded_logits():
    cfg_r, cfg_p, pj, pt = _models("smollm")
    cr = dataclasses.replace(cfg_r, vocab_true=500)
    cp = dataclasses.replace(cfg_p, vocab_true=500)
    toks = _tokens(cfg_r, 2, 9)
    lj, _ = rlm.forward_prefill(pj, cr, {"tokens": jnp.asarray(toks)}, max_seq=16)
    lt, _ = lm.forward_prefill(pt, cp, {"tokens": torch.from_numpy(toks)},
                               max_seq=16)
    assert (lt[..., 500:] == -1e9).all()
    _close(lt, lj, TOL)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_full_config_tree_has_the_reference_shapes(arch):
    """Every full config builds on the meta device with the reference's
    leaves (``jax.eval_shape`` of its ``init_params``): the same paths,
    shapes and dtypes — grok-1's 314 B tree, the MoE routers in f32 in a
    bf16 model, whisper's encoder stack and position tables included."""
    cfg_r, cfg_p = ref_configs.get(arch), configs.get(arch)
    want = jax.eval_shape(lambda: rlm.init_params(cfg_r, jax.random.PRNGKey(0)))
    got = lm.init_params(cfg_p, None, device="meta")
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (path, w), (_, g) in zip(flat_w, flat_g):
        assert g.device.type == "meta"
        assert tuple(g.shape) == w.shape, jax.tree_util.keystr(path)
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), \
            jax.tree_util.keystr(path)
    if cfg_p.family == "moe":
        assert got["layers"]["moe"]["router"].dtype == torch.float32
    n = sum(t.numel() for t in tree_leaves(got))
    assert n == sum(int(np.prod(w.shape)) for _, w in flat_w)
    if arch == "grok1_314b":
        assert 314e9 < n < 320e9


def test_port_init_draws_per_tensor_in_the_compute_dtype():
    cfg = dataclasses.replace(configs.get("qwen2_7b", reduced=True),
                              dtype="bfloat16", scan_layers=True)
    gen = torch.Generator().manual_seed(0)
    tree = lm.init_params(cfg, gen, device="cpu")
    leaves = [tree["embed"], tree["lm_head"], *tree["layers"]["attn"].values()]
    assert all(t.dtype == torch.bfloat16 for t in leaves)
    assert (tree["layers"]["attn"]["bq"] == 0).all()
    assert (tree["layers"]["norm1"]["scale"] == 1).all()
    # the same seed draws the same tree
    again = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(again["layers"]["mlp"]["wd"], tree["layers"]["mlp"]["wd"])
    # the embedding's spread is the reference's 1/sqrt(d_model)
    std = tree["embed"].float().std().item()
    assert abs(std * np.sqrt(cfg.d_model) - 1) < 0.02


def test_full_width_qwen2_tree_has_the_reference_shapes():
    cfg_r, cfg_p = ref_configs.get("qwen2_7b"), configs.get("qwen2_7b")
    assert cfg_p.scan_layers and cfg_p.num_layers == 28
    want = jax.eval_shape(lambda: rlm.init_params(cfg_r, jax.random.PRNGKey(0)))
    got = lm.init_params(cfg_p, None, device="meta")
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (path, w), (_, g) in zip(flat_w, flat_g):
        assert tuple(g.shape) == w.shape, jax.tree_util.keystr(path)
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
    n = sum(int(np.prod(w.shape)) for _, w in flat_w)
    assert n == cfg_p.param_count() == 7_615_616_512


def test_build_model_binds_the_config():
    """``build_model``'s five entries are the direct calls with ``cfg``
    bound, as the reference's bundle."""
    cfg = configs.get("qwen2_7b", reduced=True)
    m = lm.build_model(cfg)
    assert set(m) == set(rlm.build_model(ref_configs.get("qwen2_7b",
                                                          reduced=True)))
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    params = m["init"](gen(), 64, device="cpu")
    for a, b in zip(tree_leaves(params), tree_leaves(
            lm.init_params(cfg, gen(), 64, device="cpu"))):
        assert torch.equal(a, b)
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, 512, (2, 16)).astype(np.int32))
    batch = {"tokens": tokens, "labels": tokens}
    assert torch.equal(m["train"](params, batch=batch)[0],
                       lm.forward_train(params, cfg, batch)[0])
    logits, state = m["prefill"](params, batch=batch, max_seq=64)
    want, want_state = lm.forward_prefill(params, cfg, batch, max_seq=64)
    assert torch.equal(logits, want)
    step = m["decode"](params, tokens=tokens[:, :1], state=state)
    ref_step = lm.forward_decode(params, cfg, tokens[:, :1], want_state)
    assert torch.equal(step[0], ref_step[0])
    fresh = m["init_state"](2, 64, device="cpu")
    assert fresh.kv_k.shape == lm.init_decode_state(
        cfg, 2, 64, device="cpu").kv_k.shape
