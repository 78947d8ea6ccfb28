"""``repro_torch.models`` (vlm family: InternVL2, patch embeddings ahead of
the text) against ``repro.models`` on the same weights and inputs.

The reference's parameter tree (norm scales perturbed from a seed) is
carried into the port by ``load_reference_params``; the batch is the
reference's ``make_batch`` (tokens, labels, mask, ``patch_embeds``).
Everything runs in f32 on the CPU. Tolerances, as the port's other
families are held:
- ``forward_train``: loss rtol 1e-5 (the CE over the text region only),
  each gradient leaf within 1e-5 · (1 + max |g|) of ``jax.value_and_grad``'s,
  the patch embeddings' gradient included;
- prefill (a cache and ``pos`` covering the patch positions and the text),
  decode steps and the steps: rtol/atol 1e-4.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.data.synthetic import make_batch as ref_make_batch  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.data.synthetic import batch_spec, make_batch  # noqa: E402
from repro_torch.distribution import (make_decode_step,  # noqa: E402
                                      make_prefill_step, make_train_step)
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.utils import tree_leaves, tree_map  # noqa: E402
from test_torch_moe import (GRAD_TOL, LOSS_RTOL, TOL, cfgs,  # noqa: E402
                            check_grads, close, models, ref_tree,
                            state_pairs, t_batch)

NAME = "internvl2_26b"


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg_r, B, S, seed):
    return {k: np.asarray(v) for k, v in
            ref_make_batch(cfg_r, B, S, seed=seed).items()}


@pytest.mark.parametrize("stacked", [False, True])
def test_forward_train_loss_over_the_text_region_and_gradients(stacked):
    cfg_r, cfg_p = cfgs(NAME, scan_layers=stacked,
                        remat="full" if stacked else "none")
    V = cfg_r.vision_tokens
    tree = ref_tree(cfg_r)
    b = _batch(cfg_r, 2, 12, seed=1)
    assert b["patch_embeds"].shape == (2, V, cfg_r.d_model)

    def ref(p, pe):
        return rlm.forward_train(p, cfg_r, {**b, "patch_embeds": pe})[0]

    loss_r, (g_r, g_pe_r) = jax.jit(jax.value_and_grad(ref, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(b["patch_embeds"]))
    params = lm.load_reference_params(tree, cfg_p, device="cpu")
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    bt = t_batch(b)
    bt["patch_embeds"].requires_grad_(True)
    loss_p, met = lm.forward_train(leaves, cfg_p, bt)
    assert sorted(met) == ["ce_loss"]
    *g_p, g_pe = torch.autograd.grad(loss_p, tree_leaves(leaves)
                                     + [bt["patch_embeds"]])
    assert abs(float(loss_p.detach()) - float(loss_r)) <= \
        LOSS_RTOL * abs(float(loss_r))
    check_grads(cfg_p, g_p, g_r)
    err = float((g_pe - torch.from_numpy(np.array(g_pe_r))).abs().max())
    assert err < GRAD_TOL * (1 + float(np.abs(np.asarray(g_pe_r)).max()))
    # the loss is the text region's: the labels' CE on the logits after the
    # V patch positions
    x = lm._embed(params, cfg_p, bt["tokens"], bt)
    assert x.shape[1] == V + 12
    logits = lm._logits(params, cfg_p, lm._backbone(params, cfg_p, x)[0])
    ce = torch.nn.functional.cross_entropy(
        logits[:, V:].reshape(-1, cfg_p.vocab_size),
        bt["labels"].reshape(-1).long())
    close(ce, float(loss_r), dict(rtol=LOSS_RTOL, atol=0))


@pytest.mark.parametrize("stacked", [False, True])
def test_prefill_covers_the_patch_positions_then_decodes(stacked):
    cfg_r, cfg_p, pj, pt = models(NAME, scan_layers=stacked)
    V, B, S, max_seq = cfg_r.vision_tokens, 2, 9, 24
    b = _batch(cfg_r, B, S, seed=2)
    inp = {k: b[k] for k in ("tokens", "patch_embeds")}
    lj, sj = rlm.forward_prefill(pj, cfg_r, jax.tree.map(jnp.asarray, inp),
                                 max_seq=max_seq)
    lt, st = lm.forward_prefill(pt, cfg_p, t_batch(inp), max_seq=max_seq)
    close(lt, lj, TOL, "prefill")
    assert int(st.pos) == int(sj.pos) == V + S
    assert tuple(st.kv_k.shape) == sj.kv_k.shape == (
        cfg_r.num_layers, B, max_seq, cfg_r.num_kv_heads,
        cfg_r.resolved_head_dim)
    # the cache holds V + S positions (the patches' then the tokens') and
    # nothing after them
    assert bool((st.kv_k[:, :, :V + S].abs().sum(-1) > 0).all())
    assert bool((st.kv_k[:, :, V + S:] == 0).all())
    dec = jax.jit(lambda p, t, s: rlm.forward_decode(p, cfg_r, t, s))
    for step in range(3):
        tok = np.random.default_rng(10 + step).integers(
            1, cfg_r.vocab_size, (B, 1)).astype(np.int32)
        lj, sj = dec(pj, jnp.asarray(tok), sj)
        lt, st = lm.forward_decode(pt, cfg_p, torch.from_numpy(tok), st)
        close(lt, lj, TOL, f"step {step}")
    assert int(st.pos) == V + S + 3
    for label, a, w in state_pairs(st, sj):
        close(a, w, TOL, label)


def test_steps_carry_the_patch_embeddings():
    """``batch_spec``'s extras reach every step: the train step's loss,
    the prefill step's cache of V + S + 64 positions, the decode step."""
    cfg_r, cfg_p, pj, pt = models(NAME)
    V, B, S = cfg_r.vision_tokens, 2, 8
    spec = batch_spec(cfg_p, B, S)
    assert tuple(spec["patch_embeds"].shape) == (B, V, cfg_p.d_model)
    assert spec["patch_embeds"].dtype == torch.float32
    drawn = make_batch(cfg_p, B, S, seed=4, device="cpu")
    assert sorted(drawn) == sorted(spec)
    assert np.array_equal(
        drawn["patch_embeds"].numpy(),
        np.asarray(ref_make_batch(cfg_r, B, S, seed=4)["patch_embeds"]))

    train = make_train_step(cfg_p, adamw(), InputShape("t", S, B, "train"),
                            device="cpu")
    assert tuple(train.arg_specs[2]["patch_embeds"].shape) == (
        B, V, cfg_p.d_model)
    _, _, m = train.fn(pt, adamw().init(pt), drawn)
    want, _ = rlm.forward_train(pj, cfg_r, jax.tree.map(
        lambda t: jnp.asarray(t.numpy()), drawn))
    assert abs(float(m["ce_loss"]) - float(want)) <= LOSS_RTOL * float(want)

    pre = make_prefill_step(cfg_p, InputShape("p", S, B, "prefill"),
                            device="cpu")
    assert pre.meta["max_seq"] == S + 64 + V
    assert tuple(pre.arg_specs[1]["patch_embeds"].shape) == (
        B, V, cfg_p.d_model)
    inp = {k: drawn[k] for k in ("tokens", "patch_embeds")}
    lj, sj = jax.jit(lambda p, bb: rlm.forward_prefill(
        p, cfg_r, bb, max_seq=S + 64 + V))(
        pj, jax.tree.map(lambda t: jnp.asarray(t.numpy()), inp))
    lt, st = pre.fn(pt, inp)
    close(lt, lj, TOL, "prefill step")
    assert int(st.pos) == V + S
    dec = make_decode_step(cfg_p, InputShape("d", S + 64 + V, B, "decode"),
                           device="cpu")
    tok = lt[:, -1].argmax(-1).to(torch.int32)[:, None]
    logits_j, _ = rlm.forward_decode(pj, cfg_r, jnp.asarray(tok.numpy()), sj)
    top2 = np.sort(np.asarray(logits_j[:, -1]), axis=-1)[:, -2:]
    assert ((top2[:, 1] - top2[:, 0]) > 1e-3).all()
    nxt, st = dec.fn(pt, tok, st)
    assert np.array_equal(nxt.numpy()[:, 0],
                          np.asarray(logits_j[:, -1]).argmax(-1))
    assert int(st.pos) == V + S + 1
