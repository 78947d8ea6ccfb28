"""Decode in ``repro_torch``: ``attention_decode``, ``forward_decode`` for the
dense, ssm and hybrid families, and the prefill / decode steps, against
``repro`` on the same weights and inputs (the moe, vlm and audio families
have their own files: tests/test_torch_{moe,vlm,audio}.py), and the
decode-vs-prefill check over all ten architectures.

The reference's parameter tree (its init, with the zero biases, unit norm
scales and RWKV-6's degenerate ``w_bias`` / ``u_bonus`` perturbed from a
seed) is carried into the port by ``load_reference_params``. Everything
runs in f32 on the CPU. Tolerances:
- ``attention_decode``: rtol/atol 2e-5, as the port's other attention
  layers (the softmax over the cache sums in another order);
- ``forward_prefill`` then 4 chained ``forward_decode`` steps: each step's
  logits and every leaf of the final state within rtol/atol 1e-4, as
  ``forward_prefill`` is held in tests/test_torch_lm.py (measured ~3e-6
  through the reduced models);
- the port's own decode-vs-prefill check (the reference's
  ``test_decode_matches_prefill``): decode logits after a prompt of S - 1
  tokens against ``forward_prefill``'s last logits on S tokens, rtol/atol
  1e-4, tighter than the reference's 2e-2 (it is f32 here);
- the steps: their greedy tokens equal to the reference's (jitted
  ``forward_prefill``, then jitted ``forward_decode`` and ``argmax``) on
  every row whose top-2 logit margin exceeds 1e-3; measured: every row.

The reference's ``make_decode_step`` needs a mesh, and its steps do not
trace on this JAX (ROADMAP §3), so the reference side is the composition
they wrap.
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
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.data.synthetic import make_batch  # noqa: E402
from repro_torch.distribution import (make_decode_step,  # noqa: E402
                                      make_prefill_step)
from repro_torch.models import forward_decode, forward_prefill  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402

LAYER_TOL = dict(rtol=2e-5, atol=2e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
MARGIN = 1e-3


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(name, **over):
    r = ref_configs.reduce_config(ref_configs.get(name), **over)
    p = configs.reduce_config(configs.get(name), **over)
    assert dataclasses.asdict(r) == dataclasses.asdict(p)
    return r, p


def _ref_tree(cfg_r, seed=0):
    tree = jax.tree.map(np.asarray,
                        rlm.init_params(cfg_r, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        key = path[-1].key if hasattr(path[-1], "key") else ""
        if key in ("bq", "bk", "bv", "dt_bias"):
            return (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        if key in ("scale", "D"):
            return (1 + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        if key == "w_bias":
            return rng.uniform(-9.0, -1.0, a.shape).astype(a.dtype)
        if key == "u_bonus":
            return rng.standard_normal(a.shape).astype(a.dtype)
        if key in ("mix_rkvwg", "mix_cm"):
            return rng.uniform(0.0, 1.0, a.shape).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(perturb, tree)


def _models(name, **over):
    cfg_r, cfg_p = _cfgs(name, **over)
    tree = _ref_tree(cfg_r)
    return cfg_r, cfg_p, jax.tree.map(jnp.asarray, tree), \
        lm.load_reference_params(tree, cfg_p, device="cpu")


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        1, cfg.vocab_size, shape).astype(np.int32)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, tol=TOL, label=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), err_msg=label,
                               **tol)


def _state_pairs(st, sj):
    """(label, port tensor, reference array) for every leaf of a state."""
    pairs = [("pos", st.pos, sj.pos)]
    for name in ("kv_k", "kv_v"):
        a, b = getattr(st, name), getattr(sj, name)
        assert (a is None) == (b is None), name
        if a is not None:
            pairs.append((name, a, b))
    assert (st.ssm is None) == (sj.ssm is None)
    if st.ssm is not None:
        assert sorted(st.ssm) == sorted(sj.ssm)
        pairs += [(k, st.ssm[k], sj.ssm[k]) for k in st.ssm]
    return pairs


@pytest.mark.parametrize("where", ["first", "middle", "last"])
def test_attention_decode_matches_reference(where):
    """Qwen2's layer (qkv bias, GQA 4:2) at pos 0, in the middle and at
    Smax - 1, over a cache filled with values."""
    cfg_r, cfg_p, pj, pt = _models("qwen2_7b")
    Smax, B = 16, 3
    pos = {"first": 0, "middle": 9, "last": Smax - 1}[where]
    hd, nkv = cfg_r.resolved_head_dim, cfg_r.num_kv_heads
    ck, cv = _x((B, Smax, nkv, hd), 1), _x((B, Smax, nkv, hd), 2)
    x = _x((B, 1, cfg_r.d_model), 3)
    oj, kj, vj = RL.attention_decode(pj["layers"][1]["attn"], cfg_r,
                                     jnp.asarray(x), jnp.asarray(ck),
                                     jnp.asarray(cv), jnp.asarray(pos, jnp.int32))
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    ot, kt, vt = L.attention_decode(pt["layers"][1]["attn"], cfg_p,
                                    torch.from_numpy(x), tk, tv,
                                    torch.tensor(pos, dtype=torch.int32))
    _close(ot, oj, LAYER_TOL, "out")
    _close(kt, kj, LAYER_TOL, "cache_k")
    _close(vt, vj, LAYER_TOL, "cache_v")
    # written in place, at pos only
    assert kt is tk and vt is tv
    keep = np.arange(Smax) != pos
    assert np.array_equal(tk.numpy()[:, keep], ck[:, keep])


DECODE_CASES = {
    "dense": ("qwen2_7b", False),
    "dense_stacked": ("qwen2_7b", True),
    "ssm": ("rwkv6_7b", False),
    "ssm_stacked": ("rwkv6_7b", True),
    "hybrid": ("zamba2_2p7b", False),
    "hybrid_stacked": ("zamba2_2p7b", True),
}


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_prefill_and_four_decode_steps_match_reference(case):
    name, stacked = DECODE_CASES[case]
    cfg_r, cfg_p, pj, pt = _models(name, scan_layers=stacked)
    B, S, max_seq = 2, 11, 16
    toks = _tokens(cfg_r, (B, S), 1)
    lj, sj = rlm.forward_prefill(pj, cfg_r, {"tokens": jnp.asarray(toks)},
                                 max_seq=max_seq)
    lt, st = forward_prefill(pt, cfg_p, {"tokens": torch.from_numpy(toks)},
                             max_seq=max_seq)
    _close(lt, lj, TOL, f"{case} prefill")
    dec = jax.jit(lambda p, t, s: rlm.forward_decode(p, cfg_r, t, s))
    for step in range(4):
        tok = _tokens(cfg_r, (B, 1), 10 + step)
        lj, sj = dec(pj, jnp.asarray(tok), sj)
        lt, st = forward_decode(pt, cfg_p, torch.from_numpy(tok), st)
        assert tuple(lt.shape) == (B, 1, cfg_r.vocab_size)
        _close(lt, lj, TOL, f"{case} step {step}")
    assert int(st.pos) == int(sj.pos) == S + 4
    for label, a, b in _state_pairs(st, sj):
        assert tuple(a.shape) == b.shape, label
        _close(a, b, TOL, f"{case} state {label}")


PORTED_ARCHS = [a for a in configs.ARCH_IDS
                if configs.get(a).family in lm.PORTED]


def test_six_architectures_are_ported():
    """The six families of the reference, and with them all ten
    architectures."""
    assert sorted(lm.PORTED) == sorted(["dense", "ssm", "hybrid", "moe",
                                        "vlm", "audio"])
    assert sorted(PORTED_ARCHS) == sorted(configs.ARCH_IDS) == sorted([
        "zamba2_2p7b", "qwen2_7b", "deepseek_coder_33b", "stablelm_12b",
        "smollm_135m", "rwkv6_7b", "qwen2_moe_a2p7b", "grok1_314b",
        "internvl2_26b", "whisper_large_v3"])


@pytest.mark.parametrize("arch", PORTED_ARCHS)
def test_decode_matches_prefill(arch):
    """decode(token_S | prefill(0..S-1)) == prefill(0..S) last-position
    logits, on the port's own init and batch (a VLM's patch embeddings and
    whisper's frames with the tokens; the reduced MoE's capacity factor 8
    drops nothing on either route)."""
    cfg = configs.get(arch, reduced=True)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    batch = make_batch(cfg, 2, 24, seed=1, device="cpu")
    extras = {k: v for k, v in batch.items()
              if k in ("patch_embeds", "frames")}
    toks = batch["tokens"]
    _, state = forward_prefill(params, cfg, {**extras, "tokens": toks[:, :23]},
                               max_seq=64 + cfg.vision_tokens)
    dec, new = forward_decode(params, cfg, toks[:, 23:], state)
    full, _ = forward_prefill(params, cfg, {**extras, "tokens": toks},
                              max_seq=64 + cfg.vision_tokens)
    assert int(new.pos) == 24 + cfg.vision_tokens
    assert torch.isfinite(dec).all()
    _close(dec, full.numpy(), TOL, arch)


STEP_CASES = {"dense": ("qwen2_7b", False), "hybrid_stacked": ("zamba2_2p7b", True)}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_prefill_and_decode_steps_match_the_reference_composition(case):
    name, stacked = STEP_CASES[case]
    cfg_r, cfg_p, pj, pt = _models(name, scan_layers=stacked)
    B, S = 3, 10
    shape = InputShape("p", S, B, "prefill")
    pre = make_prefill_step(cfg_p, shape, device="cpu")
    assert pre.meta["max_seq"] == S + 64
    toks = _tokens(cfg_r, (B, S), 2)
    lj, sj = jax.jit(lambda p, b: rlm.forward_prefill(p, cfg_r, b,
                                                      max_seq=S + 64))(
        pj, {"tokens": jnp.asarray(toks)})
    lt, st = pre.fn(pt, {"tokens": torch.from_numpy(toks)})
    _close(lt, lj, TOL, "prefill")
    dec = make_decode_step(cfg_p, InputShape("d", S + 64, B, "decode"),
                           device="cpu")
    assert dec.meta["max_seq"] == S + 64

    def ref_step(p, t, s):
        logits, s = rlm.forward_decode(p, cfg_r, t, s)
        return (jnp.argmax(logits[:, -1, :], axis=-1).astype(jnp.int32)[:, None],
                logits, s)

    ref_step = jax.jit(ref_step)
    tok_j = jnp.argmax(lj[:, -1, :], axis=-1).astype(jnp.int32)[:, None]
    tok_t = torch.from_numpy(np.array(tok_j))
    for step in range(3):
        tok_j, logits_j, sj = ref_step(pj, tok_j, sj)
        tok_t, st = dec.fn(pt, tok_t, st)
        assert tok_t.dtype == torch.int32 and tuple(tok_t.shape) == (B, 1)
        top2 = np.sort(np.asarray(logits_j[:, -1]), axis=-1)[:, -2:]
        robust = (top2[:, 1] - top2[:, 0]) > MARGIN
        assert robust.all(), (step, top2)
        assert np.array_equal(tok_t.numpy()[robust], np.asarray(tok_j)[robust])
    # the specs are the arguments' shapes on the meta device
    params_s, tok_s, state_s = dec.arg_specs
    assert all(t.device.type == "meta" for t in tree_leaves(
        [params_s, tok_s, list(state_s)]) if t is not None)
    shapes = lambda tree: {jax.tree_util.keystr(k): tuple(t.shape) for k, t
                           in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert shapes(params_s) == shapes(pt)
    assert tuple(tok_s.shape) == (B, 1) and tok_s.dtype == torch.int32
    for (label, got, _), (_, spec, _) in zip(
            _state_pairs(st, sj), _state_pairs(state_s, sj)):
        assert got.shape == spec.shape, label
    assert tuple(pre.arg_specs[1]["tokens"].shape) == (B, S)


def test_steps_refuse_meshes_and_name_their_device():
    _, cfg = _cfgs("qwen2_7b")
    shape = InputShape("d", 32, 2, "decode")
    for make in (make_prefill_step, make_decode_step):
        # a mesh is a DeviceMesh (tests/test_torch_lm_mesh.py runs them);
        # expert parallelism needs one
        with pytest.raises(TypeError, match="DeviceMesh"):
            make(cfg, shape, device="cpu", mesh=object())
        with pytest.raises(ValueError, match="mesh="):
            make(cfg, shape, device="cpu", ep=True)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make(cfg, shape)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    step = make_decode_step(cfg, shape, device="meta")
    with pytest.raises(ValueError, match="parameters are on cpu"):
        step.fn(params, torch.zeros((2, 1), dtype=torch.int32),
                lm.init_decode_state(cfg, 2, 32, device="cpu"))
