"""``repro_torch.models`` (ssm family, RWKV-6) against ``repro.models`` on
the same weights and inputs, and ``forward_train`` for the dense family.

The reference's parameter tree is carried into the port by
``load_reference_params``, with ``u_bonus`` and ``w_bias`` perturbed from
a seed (the reference initialises them to 0 and -6, which makes every
decay ~0.9975 and the bonus term zero) and the norm scales and token-shift
mixes perturbed too. Everything runs in f32 on the CPU. Tolerance:
rtol/atol 1e-4 through the whole reduced model (four layers and the head;
the two frameworks sum the matmuls and the chunked recurrence in other
orders, ~1e-6 relative a layer); 2e-5 for the token shift and the channel
mix, 1e-4 for the time mix (its recurrence sums ~hd·S terms).

The full-width check builds the port's rwkv6-7b tree on the ``meta``
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
from repro.data import synthetic as ref_synthetic  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402

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


def _ref_tree(cfg_r, seed=0):
    """The reference's init, as numpy, with the degenerate leaves replaced
    by seeded values: ``w_bias`` spread over [-9, -1] (decays from ~1 down
    to ~0.07 per step; the clip at -8 and the clamp both bite), ``u_bonus``
    ~ N(0, 1), norm scales and token-shift mixes around their init."""
    tree = jax.tree.map(np.asarray,
                        rlm.init_params(cfg_r, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        key = path[-1].key if hasattr(path[-1], "key") else ""
        if key == "w_bias":
            return rng.uniform(-9.0, -1.0, a.shape).astype(a.dtype)
        if key == "u_bonus":
            return rng.standard_normal(a.shape).astype(a.dtype)
        if key == "scale":
            return (1 + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        if key in ("mix_rkvwg", "mix_cm"):
            return rng.uniform(0.0, 1.0, a.shape).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(perturb, tree)


def _models(stacked=False, **over):
    cfg_r, cfg_p = _cfgs("rwkv6_7b", scan_layers=stacked, **over)
    tree = _ref_tree(cfg_r)
    return cfg_r, cfg_p, jax.tree.map(jnp.asarray, tree), \
        lm.load_reference_params(tree, cfg_p, device="cpu")


def _x(shape, seed=2):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, tol=TOL, label=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), err_msg=label,
                               **tol)


def _state(cfg, B, seed):
    """A non-zero decode state (shifts and wkv) in both frameworks."""
    rng = np.random.default_rng(seed)
    H, hd, d = cfg.num_heads, cfg.ssm_head_dim, cfg.d_model
    st = {"shift_tm": rng.standard_normal((B, 1, d)),
          "shift_cm": rng.standard_normal((B, 1, d)),
          "wkv": rng.standard_normal((B, H, hd, hd))}
    st = {k: v.astype(np.float32) for k, v in st.items()}
    return ({k: jnp.asarray(v) for k, v in st.items()},
            {k: torch.from_numpy(v) for k, v in st.items()})


def test_token_shift_matches_reference():
    x = _x((2, 9, 16))
    prev = _x((2, 1, 16), 3)
    _close(L._token_shift(torch.from_numpy(x), None),
           RL._token_shift(jnp.asarray(x), None), LAYER_TOL)
    _close(L._token_shift(torch.from_numpy(x), torch.from_numpy(prev)),
           RL._token_shift(jnp.asarray(x), jnp.asarray(prev)), LAYER_TOL)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("impl", ["chunked", "pallas"])
def test_time_mix_and_channel_mix_match_reference(impl, with_state):
    """rwkv6_time_mix ("chunked", and "pallas" against the reference's
    interpret route) and rwkv6_channel_mix on a layer with carried weights,
    with and without a decode state, at S=40 over chunks of 16 (a ragged
    tail)."""
    cfg_r, cfg_p, pj, pt = _models(wkv_chunk=16)
    x = _x((2, 40, cfg_r.d_model), 4)
    lj, lt = pj["layers"][1], pt["layers"][1]
    sj, st = _state(cfg_r, 2, 5) if with_state else (None, None)
    oj, nj = RL.rwkv6_time_mix(lj, cfg_r, jnp.asarray(x), state=sj, impl=impl)
    ot, nt = L.rwkv6_time_mix(lt, cfg_p, torch.from_numpy(x), state=st,
                              impl=impl)
    _close(ot, oj, TOL, f"time mix {impl}")
    cj, mj = RL.rwkv6_channel_mix(lj, cfg_r, jnp.asarray(x), state=sj)
    ct, mt = L.rwkv6_channel_mix(lt, cfg_p, torch.from_numpy(x), state=st)
    _close(ct, cj, LAYER_TOL, "channel mix")
    if with_state:
        for key in ("shift_tm", "wkv"):
            _close(nt[key], nj[key], TOL, f"time-mix state {key}")
        _close(mt["shift_cm"], mj["shift_cm"], LAYER_TOL)
    else:
        assert nt is None and mt is None


@pytest.mark.parametrize("stacked", [False, True], ids=["list", "stacked"])
def test_forward_train_and_prefill_match_reference(stacked):
    """forward_train's loss (with the reference's make_batch draws, carried
    bit for bit) and forward_prefill's last-position logits and per-layer
    ssm states, on reduced rwkv6 (4 layers) with both layer layouts."""
    cfg_r, cfg_p, pj, pt = _models(stacked)
    B, S = 3, 40
    bj = ref_synthetic.make_batch(cfg_r, B, S, seed=7)
    bt = synthetic.make_batch(cfg_p, B, S, seed=7, device="cpu")
    for key in ("tokens", "labels", "mask"):
        np.testing.assert_array_equal(bt[key].numpy(), np.asarray(bj[key]))
    assert bt["tokens"].dtype == torch.int32
    loss_j, mj = rlm.forward_train(pj, cfg_r, bj)
    loss_t, mt = lm.forward_train(pt, cfg_p, bt)
    _close(loss_t, loss_j, TOL, "loss")
    _close(mt["ce_loss"], mj["ce_loss"], TOL)
    lj, sj = rlm.forward_prefill(pj, cfg_r, {"tokens": bj["tokens"]},
                                 max_seq=64)
    lt, st = lm.forward_prefill(pt, cfg_p, {"tokens": bt["tokens"]},
                                max_seq=64)
    assert tuple(lt.shape) == (B, 1, cfg_r.vocab_size)
    _close(lt, lj, TOL, "prefill logits")
    assert int(st.pos) == int(sj.pos) == S and st.kv_k is None
    for key in ("shift_tm", "shift_cm", "wkv"):
        assert tuple(st.ssm[key].shape) == sj.ssm[key].shape
        _close(st.ssm[key], sj.ssm[key], TOL, f"ssm state {key}")
    # score_last runs the chunked backbone without a state: same logits
    _close(lm.score_last(pt, cfg_p, bt["tokens"]), lj, TOL, "score_last")


def test_forward_train_dense_matches_reference():
    cfg_r, cfg_p = _cfgs("qwen2_7b")
    tree = jax.tree.map(np.asarray,
                        rlm.init_params(cfg_r, jax.random.PRNGKey(1)))
    pt = lm.load_reference_params(tree, cfg_p, device="cpu")
    bj = ref_synthetic.make_batch(cfg_r, 2, 24, seed=3)
    bt = synthetic.make_batch(cfg_p, 2, 24, seed=3, device="cpu")
    bt["mask"][1, 10:] = 0  # a partial mask: the loss is its weighted mean
    bj = {**bj, "mask": jnp.asarray(bt["mask"].numpy())}
    loss_j, _ = rlm.forward_train(jax.tree.map(jnp.asarray, tree), cfg_r, bj)
    loss_t, _ = lm.forward_train(pt, cfg_p, bt)
    _close(loss_t, loss_j, TOL, "dense loss")


def test_softmax_cross_entropy_matches_reference():
    from repro.utils import softmax_cross_entropy as ref_ce
    from repro_torch.utils import softmax_cross_entropy

    logits = 5 * _x((3, 7, 50), 8)
    labels = np.random.default_rng(9).integers(0, 50, (3, 7)).astype(np.int32)
    _close(softmax_cross_entropy(torch.from_numpy(logits),
                                 torch.from_numpy(labels)),
           ref_ce(jnp.asarray(logits), jnp.asarray(labels)), LAYER_TOL)


def test_init_decode_state_resolves_its_device():
    """device=None means the card, as at every entry point: without one it
    raises; device="cpu" allocates there, for every family (whisper's cross
    K/V too)."""
    for name in ("qwen2_7b", "rwkv6_7b", "qwen2_moe_a2p7b",
                 "whisper_large_v3"):
        cfg = configs.get(name, reduced=True)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                lm.init_decode_state(cfg, 2, 16)
        st = lm.init_decode_state(cfg, 2, 16, device="cpu")
        leaves = [st.pos, *(st.ssm.values() if st.ssm else (st.kv_k,))]
        if cfg.family == "audio":
            leaves += [st.cross_k, st.cross_v]
        assert all(t.device.type == "cpu" for t in leaves)


def test_full_width_rwkv6_tree_has_the_reference_shapes():
    cfg_r, cfg_p = ref_configs.get("rwkv6_7b"), configs.get("rwkv6_7b")
    assert cfg_p.scan_layers and cfg_p.num_layers == 32
    assert (cfg_p.d_model, cfg_p.num_heads, cfg_p.ssm_head_dim, cfg_p.d_ff,
            cfg_p.vocab_size, cfg_p.wkv_chunk) == (4096, 64, 64, 14336,
                                                   65536, 32)
    want = jax.eval_shape(lambda: rlm.init_params(cfg_r, jax.random.PRNGKey(0)))
    got = lm.init_params(cfg_p, None, device="meta")
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (path, w), (_, g) in zip(flat_w, flat_g):
        assert tuple(g.shape) == w.shape, jax.tree_util.keystr(path)
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
    n = sum(int(np.prod(w.shape)) for _, w in flat_w)
    assert n == 7_534_546_944
