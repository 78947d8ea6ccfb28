"""``repro_torch.models`` (audio family: whisper, a non-causal encoder over
the stub front end's frames and a decoder with self- and cross-attention)
against ``repro.models`` on the same weights and inputs.

The reference's parameter tree (norm scales perturbed from a seed) is
carried into the port by ``load_reference_params``; frames are the
reference's ``make_batch`` draws. Everything runs in f32 on the CPU.
Under ``attn_impl="pallas"`` the reference runs its Pallas kernel in
interpret mode and the port the kernel's plain version (CPU tensors); the
cross-attention takes the chunked path on both sides. Tolerances, as the
port's other layers and families are held:
- the encoder (under ``pallas`` and ``chunked``), ``_xattn_block``:
  rtol/atol 2e-5;
- prefill (logits, self and cross K/V), decode steps (``dec_pos`` at
  ``pos``, clamped into its table as ``dynamic_slice_in_dim`` clamps),
  ``forward_train`` and the steps: rtol/atol 1e-4; the loss rtol 1e-5 and
  each gradient leaf within 1e-5 · (1 + max |g|) of
  ``jax.value_and_grad``'s.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.data.synthetic import make_batch as ref_make_batch  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.data.synthetic import batch_spec  # noqa: E402
from repro_torch.distribution import (make_decode_step,  # noqa: E402
                                      make_prefill_step, make_train_step)
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.utils import tree_leaves, tree_map  # noqa: E402
from test_torch_moe import (LAYER_TOL, LOSS_RTOL, TOL, cfgs,  # noqa: E402
                            check_grads, close, models, ref_tree,
                            state_pairs, t_batch)

NAME = "whisper_large_v3"


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg_r, B, S, seed):
    return {k: np.asarray(v) for k, v in
            ref_make_batch(cfg_r, B, S, seed=seed).items()}


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("impl", ["pallas", "chunked"])
def test_encoder_matches_reference(impl):
    """Non-causal self-attention over the frames: under ``pallas`` the
    kernel's plain version here, the Pallas kernel (interpret mode) there;
    an attention chunk that leaves a ragged tail for ``chunked``."""
    cfg_r, cfg_p, pj, pt = models(NAME, attn_impl=impl, attn_chunk=5,
                                  scan_layers=impl == "pallas")
    frames = _x((2, cfg_r.encoder_seq, cfg_r.d_model), 3)
    want = rlm._encoder(pj, cfg_r, jnp.asarray(frames), rlm._noshard)
    got = lm._encoder(pt, cfg_p, torch.from_numpy(frames))
    close(got, want, LAYER_TOL)
    # non-causal: the last frame changes every output position
    moved = frames.copy()
    moved[:, -1] += 1.0
    again = lm._encoder(pt, cfg_p, torch.from_numpy(moved))
    assert bool(((again - got).abs().amax(-1) > 1e-4).all())


@pytest.mark.parametrize("impl", ["pallas", "chunked"])
def test_xattn_block_matches_reference(impl):
    cfg_r, cfg_p, pj, pt = models(NAME, attn_impl=impl)
    x = _x((2, 7, cfg_r.d_model), 4)
    enc = _x((2, cfg_r.encoder_seq, cfg_r.d_model), 5)
    want = rlm._xattn_block(pj["layers"][1], cfg_r, jnp.asarray(x),
                            jnp.asarray(enc), rlm._noshard)
    got = lm._xattn_block(pt["layers"][1], cfg_p, torch.from_numpy(x),
                          torch.from_numpy(enc))
    close(got, want, LAYER_TOL)


@pytest.mark.parametrize("stacked", [False, True])
def test_prefill_cross_kv_and_decode_steps_match_reference(stacked):
    cfg_r, cfg_p, pj, pt = models(NAME, scan_layers=stacked,
                                  attn_impl="pallas")
    B, S, max_seq = 2, 6, 16
    b = _batch(cfg_r, B, S, seed=2)
    inp = {k: b[k] for k in ("tokens", "frames")}
    lj, sj = rlm.forward_prefill(pj, cfg_r, jax.tree.map(jnp.asarray, inp),
                                 max_seq=max_seq)
    lt, st = lm.forward_prefill(pt, cfg_p, t_batch(inp), max_seq=max_seq)
    close(lt, lj, TOL, "prefill")
    F = cfg_r.encoder_seq
    assert tuple(st.cross_k.shape) == sj.cross_k.shape == (
        cfg_r.num_layers, B, F, cfg_r.num_kv_heads, cfg_r.resolved_head_dim)
    close(st.cross_k, sj.cross_k, TOL, "cross_k")
    close(st.cross_v, sj.cross_v, TOL, "cross_v")
    dec = jax.jit(lambda p, t, s: rlm.forward_decode(p, cfg_r, t, s))
    for step in range(3):
        tok = np.random.default_rng(10 + step).integers(
            1, cfg_r.vocab_size, (B, 1)).astype(np.int32)
        lj, sj = dec(pj, jnp.asarray(tok), sj)
        lt, st = lm.forward_decode(pt, cfg_p, torch.from_numpy(tok), st)
        close(lt, lj, TOL, f"step {step}")
    assert int(st.pos) == S + 3
    for label, a, w in state_pairs(st, sj):
        close(a, w, TOL, label)


def test_decode_adds_dec_pos_at_a_clamped_pos():
    """Past the end of ``dec_pos`` (4096 rows) the reference's
    ``dynamic_slice_in_dim`` clamps the start to the last row: decode at
    pos 4094 (in the table) and 4097 (clamped to 4095), on a cache of 4100
    positions."""
    cfg_r, cfg_p, pj, pt = models(NAME)
    assert pt["dec_pos"].shape[0] == 4096
    B, S, max_seq = 2, 5, 4100
    b = _batch(cfg_r, B, S, seed=6)
    inp = {k: b[k] for k in ("tokens", "frames")}
    _, sj0 = rlm.forward_prefill(pj, cfg_r, jax.tree.map(jnp.asarray, inp),
                                 max_seq=max_seq)
    _, st0 = lm.forward_prefill(pt, cfg_p, t_batch(inp), max_seq=max_seq)
    tok = np.array([[3], [7]], np.int32)
    outs = {}
    for pos in (4094, 4097):
        sj = sj0._replace(pos=jnp.asarray(pos, jnp.int32))
        st = st0._replace(pos=torch.tensor(pos, dtype=torch.int32),
                          kv_k=st0.kv_k.clone(), kv_v=st0.kv_v.clone())
        lj, sj = rlm.forward_decode(pj, cfg_r, jnp.asarray(tok), sj)
        lt, st = lm.forward_decode(pt, cfg_p, torch.from_numpy(tok), st)
        close(lt, lj, TOL, f"pos {pos}")
        close(st.kv_k, sj.kv_k, TOL, f"pos {pos} kv_k")
        assert int(st.pos) == pos + 1
        outs[pos] = lt
    # the clamped row is the table's last: the same step with that row
    # added by hand gives the same logits
    st = st0._replace(pos=torch.tensor(4097, dtype=torch.int32),
                      kv_k=st0.kv_k.clone(), kv_v=st0.kv_v.clone())
    pt2 = dict(pt, dec_pos=pt["dec_pos"][[4095] * 4096])
    lt2, _ = lm.forward_decode(pt2, cfg_p, torch.from_numpy(tok), st)
    assert torch.equal(lt2, outs[4097])


def test_forward_train_loss_and_gradients_match_value_and_grad():
    """On the chunked attention: the reference's Pallas kernel has no JVP,
    and its training runs chunked."""
    cfg_r, cfg_p = cfgs(NAME, remat="full", scan_layers=True)
    tree = ref_tree(cfg_r)
    b = _batch(cfg_r, 2, 10, seed=1)
    fn = jax.jit(jax.value_and_grad(
        lambda p: rlm.forward_train(p, cfg_r, b)[0]))
    loss_r, g_r = fn(jax.tree.map(jnp.asarray, tree))
    params = lm.load_reference_params(tree, cfg_p, device="cpu")
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss_p, _ = lm.forward_train(leaves, cfg_p, t_batch(b))
    g_p = torch.autograd.grad(loss_p, tree_leaves(leaves))
    assert abs(float(loss_p.detach()) - float(loss_r)) <= \
        LOSS_RTOL * abs(float(loss_r))
    check_grads(cfg_p, g_p, g_r)
    # the encoder and both position tables take gradients
    names = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(params)[0]]
    for key in ("['enc_pos']", "['dec_pos']", "['enc_norm']['scale']"):
        assert float(g_p[names.index(key)].abs().sum()) > 0, key


def test_steps_carry_the_frames():
    cfg_r, cfg_p, pj, pt = models(NAME)
    B, S = 2, 6
    spec = batch_spec(cfg_p, B, S)
    assert tuple(spec["frames"].shape) == (B, cfg_p.encoder_seq,
                                           cfg_p.d_model)
    b = _batch(cfg_r, B, S, seed=7)
    train = make_train_step(cfg_p, adamw(), InputShape("t", S, B, "train"),
                            device="cpu")
    assert sorted(train.arg_specs[2]) == sorted(spec)
    # dec_pos sized as the reference's steps size it: max(seq, 4096) rows
    assert tuple(train.arg_specs[0]["dec_pos"].shape) == (4096, cfg_p.d_model)
    _, _, m = train.fn(pt, adamw().init(pt), t_batch(b))
    want, _ = rlm.forward_train(pj, cfg_r, jax.tree.map(jnp.asarray, b))
    assert abs(float(m["ce_loss"]) - float(want)) <= LOSS_RTOL * float(want)

    pre = make_prefill_step(cfg_p, InputShape("p", S, B, "prefill"),
                            device="cpu")
    assert pre.meta["max_seq"] == S + 64
    inp = {k: b[k] for k in ("tokens", "frames")}
    lj, sj = jax.jit(lambda p, bb: rlm.forward_prefill(
        p, cfg_r, bb, max_seq=S + 64))(pj, jax.tree.map(jnp.asarray, inp))
    lt, st = pre.fn(pt, t_batch(inp))
    close(lt, lj, TOL, "prefill step")
    close(st.cross_k, sj.cross_k, TOL, "cross_k")
    dec = make_decode_step(cfg_p, InputShape("d", S + 64, B, "decode"),
                           device="cpu")
    _, _, state_spec = dec.arg_specs
    assert tuple(state_spec.cross_k.shape) == tuple(st.cross_k.shape)
    assert state_spec.cross_k.device.type == "meta"
    tok = lt[:, -1].argmax(-1).to(torch.int32)[:, None]
    logits_j, _ = rlm.forward_decode(pj, cfg_r, jnp.asarray(tok.numpy()), sj)
    top2 = np.sort(np.asarray(logits_j[:, -1]), axis=-1)[:, -2:]
    assert ((top2[:, 1] - top2[:, 0]) > 1e-3).all()
    nxt, st = dec.fn(pt, tok, st)
    assert np.array_equal(nxt.numpy()[:, 0],
                          np.asarray(logits_j[:, -1]).argmax(-1))
