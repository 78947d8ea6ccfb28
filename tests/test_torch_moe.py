"""``repro_torch.models`` (moe family: Qwen2-MoE and grok-1, GShard experts)
against ``repro.models`` on the same weights and inputs.

The reference's parameter tree is carried into the port by
``load_reference_params`` (the router stays f32), with the norm scales and
the shared expert's gate perturbed from a seed (the reference initialises
them to 1 and 0) and, for the model-level cases, one seeded vector added to
every embedding row: a direction shared by all tokens tilts the routers
towards some experts, so that the published capacity factor 1.25 drops
tokens in these short sequences, as long sequences of real text do.
Everything runs in f32 on the CPU.

Routing is held exactly: the gate indices and per-expert counts against the
reference's own router lines (``jax.nn.softmax`` then ``jax.lax.top_k``),
and ``moe_drop_frac`` bit for bit. ``torch.topk`` and ``lax.top_k`` may
break near-ties differently, so the inputs are guarded by a top-k margin:
every token's k + 1 largest router probabilities must be at least
``MARGIN`` apart, fifty times the two packages' f32 probabilities'
agreement (~2e-7 a few layers deep). The layer tests redraw the tokens
below it (``_guarded_x`` counts them). The model tests draw their tokens
from the first seed whose port run clears it at every router call
(``guarded_seed``; without the guard ~1 token in 500 of these reduced
models falls within 1e-4), then record every router call of the port
while they compare and fail if a token falls below it. Tolerances:
- ``moe_apply``: output and ``moe_lb_loss`` rtol/atol 2e-5, as the port's
  other layers;
- ``forward_train``: loss rtol 1e-5, each gradient leaf within
  1e-5 · (1 + max |g|) of ``jax.value_and_grad``'s, as
  tests/test_torch_hybrid.py holds the hybrid;
- prefill then decode steps: logits and every state leaf rtol/atol 1e-4,
  as tests/test_torch_decode.py holds the other families;
- ``StreamEngine`` on the reduced MoE: its sink rows equal the
  reference's engine's, as tests/test_torch_stream_engine.py holds SmolLM.
"""
import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro import optim as ropt  # noqa: E402
from repro.data.synthetic import make_batch as ref_make_batch  # noqa: E402
from repro.engine import EngineConfig as RefEngineConfig  # noqa: E402
from repro.engine import StreamEngine as RefStreamEngine  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro_torch import configs, optim  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.distribution import (make_decode_step,  # noqa: E402
                                      make_prefill_step, make_train_step)
from repro_torch.engine import EngineConfig, StreamEngine  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.utils import tree_leaves, tree_map  # noqa: E402

LAYER_TOL = dict(rtol=2e-5, atol=2e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = 1e-5
LOSS_RTOL = 1e-5
MARGIN = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfgs(name, **over):
    """The reduced config in both packages (equal field for field), with
    ``over`` applied to each."""
    r = ref_configs.reduce_config(ref_configs.get(name), **over)
    p = configs.reduce_config(configs.get(name), **over)
    assert dataclasses.asdict(r) == dataclasses.asdict(p)
    return r, p


def ref_tree(cfg_r, seed=0, max_seq=0, tilt=0.0):
    """The reference's init as numpy, with its constant leaves (norm
    scales, zero biases and gates) replaced by seeded values around them,
    and ``tilt`` times a seeded unit vector added to every embedding row."""
    tree = jax.tree.map(np.asarray, rlm.init_params(
        cfg_r, jax.random.PRNGKey(seed), max_seq=max_seq))
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        key = path[-1].key if hasattr(path[-1], "key") else ""
        if key == "scale":
            return (1 + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        if key in ("bq", "bk", "bv", "shared_gate"):
            return (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    tree = jax.tree_util.tree_map_with_path(perturb, tree)
    if tilt:
        u = rng.standard_normal(cfg_r.d_model)
        tree["embed"] = (tree["embed"] + tilt * u / np.linalg.norm(u)).astype(
            tree["embed"].dtype)
    return tree


def models(name, tree_kw=None, **over):
    """(cfg_r, cfg_p, reference params, port params) on one numpy tree."""
    cfg_r, cfg_p = cfgs(name, **over)
    tree = ref_tree(cfg_r, **(tree_kw or {}))
    return cfg_r, cfg_p, jax.tree.map(jnp.asarray, tree), \
        lm.load_reference_params(tree, cfg_p, device="cpu")


def close(got, want, tol=TOL, label=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), err_msg=label,
                               **tol)


def state_pairs(st, sj):
    """(label, port tensor, reference array) for every leaf of a state."""
    pairs = [("pos", st.pos, sj.pos)]
    for name in ("kv_k", "kv_v", "cross_k", "cross_v"):
        a, b = getattr(st, name), getattr(sj, name)
        assert (a is None) == (b is None), name
        if a is not None:
            pairs.append((name, a, b))
    assert (st.ssm is None) == (sj.ssm is None)
    return pairs


def t_batch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def ref_loss_and_grads(cfg_r, tree, b):
    fn = jax.jit(jax.value_and_grad(
        lambda p, bb: rlm.forward_train(p, cfg_r, bb), has_aux=True))
    (loss, metrics), g = fn(jax.tree.map(jnp.asarray, tree), b)
    return float(loss), metrics, g


def check_grads(cfg_p, g_p, g_r):
    want = tree_leaves(lm.load_reference_params(
        jax.tree.map(np.asarray, g_r), cfg_p, device="cpu"))
    assert len(want) == len(g_p)
    for g, w in zip(g_p, want):
        assert g.shape == w.shape and torch.isfinite(g).all()
        err = float((g - w).abs().max()) / (1.0 + float(w.abs().max()))
        assert err < GRAD_TOL, err


@contextlib.contextmanager
def recording():
    """Every token's smallest gap between its k + 1 largest router
    probabilities, over every ``moe_route`` call of the port in the
    block."""
    seen = []
    route0 = L.moe_route

    def route(p, cfg, x):
        r = route0(p, cfg, x)
        top = torch.topk(r[0].detach(), cfg.moe_top_k + 1, dim=-1).values
        seen.append((top[..., :-1] - top[..., 1:]).min(dim=-1).values.flatten())
        return r

    L.moe_route = route
    try:
        yield seen
    finally:
        L.moe_route = route0


@pytest.fixture
def margins():
    with recording() as seen:
        yield seen


def below_margin(seen) -> int:
    return int((torch.cat(seen) < MARGIN).sum())


def assert_margin(seen):
    below = below_margin(seen)
    assert below == 0, f"{below} of {torch.cat(seen).numel()} tokens " \
        f"within {MARGIN}"


def guarded_seed(run, margins: list, first: int = 0, tries: int = 20) -> int:
    """The first seed from ``first`` for which ``run(seed)`` (the port's
    side of a test, without gradients) routes every token clear of
    MARGIN. The test's own record (``margins``) starts after it."""
    for seed in range(first, first + tries):
        with recording() as seen, torch.no_grad():
            run(seed)
        if below_margin(seen) == 0:
            margins.clear()
            return seed
    raise AssertionError(f"no seed in {first}..{first + tries - 1} clears "
                         f"the routing margin")


# ---------------------------------------------------------------------------
# The layer
# ---------------------------------------------------------------------------


def _router_gaps(router, x, k):
    """Each token's smallest gap between its k + 1 largest router
    probabilities, in f64."""
    z = x.astype(np.float64) @ router.astype(np.float64)
    p = np.exp(z - z.max(-1, keepdims=True))
    p = np.sort(p / p.sum(-1, keepdims=True), axis=-1)[..., ::-1][..., :k + 1]
    return (p[..., :-1] - p[..., 1:]).min(-1)


def _guarded_x(router, shape, k, seed, tilt):
    """N(0, 1) tokens plus ``tilt`` along router column 0 (expert 0 gains
    ~tilt of logit, so that a capacity factor of 1.25 drops tokens), every
    token redrawn until its router probabilities clear MARGIN. Returns the
    tokens and how many were redrawn."""
    rng = np.random.default_rng(seed)
    u = router[:, 0] / np.linalg.norm(router[:, 0])
    draw = lambda n: rng.standard_normal((n, shape[-1])) + tilt * u  # noqa: E731
    x = draw(int(np.prod(shape[:-1])))
    redrawn = 0
    while True:
        low = np.flatnonzero(_router_gaps(router, x, k) < MARGIN)
        if not low.size:
            return x.reshape(shape).astype(np.float32), redrawn
        redrawn += low.size
        x[low] = draw(low.size)


def _ref_routing(router, groups, k, E):
    """The reference's router (layers.py:361-363) and its counts
    (:378-381) on the dispatch groups."""
    probs = jax.nn.softmax(jnp.asarray(groups, jnp.float32)
                           @ jnp.asarray(router), axis=-1)
    _, idx = jax.lax.top_k(probs, k)
    counts = jax.nn.one_hot(idx, E, dtype=jnp.int32).sum(axis=(1, 2))
    return np.asarray(idx), np.asarray(counts)


#: (capacity factor, moe_group_size, grok-1's shape): at 8.0 (the reduced
#: configs' value) nothing drops; at the published 1.25 with the tilt,
#: tokens drop in 64-token rows and in 16-token groups
MOE_CASES = {
    "cf8": ("qwen2_moe_a2p7b", 8.0, 0),
    "cf8_groups16": ("qwen2_moe_a2p7b", 8.0, 16),
    "cf1.25_drops": ("qwen2_moe_a2p7b", 1.25, 0),
    "cf1.25_groups16_drops": ("qwen2_moe_a2p7b", 1.25, 16),
    "grok_cf1.25_drops": ("grok1_314b", 1.25, 0),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_apply_matches_reference(case):
    name, cf, G = MOE_CASES[case]
    cfg_r, cfg_p = cfgs(name, moe_capacity_factor=cf, moe_group_size=G)
    p_np = ref_tree(cfg_r)["layers"][1]["moe"]
    assert p_np["router"].dtype == np.float32
    assert ("shared" in p_np) == bool(cfg_r.num_shared_experts)
    E, k, d = cfg_r.num_experts, cfg_r.moe_top_k, cfg_r.d_model
    x, redrawn = _guarded_x(p_np["router"], (3, 64, d), k, seed=4,
                            tilt=1.5 if cf < 8 else 0.0)
    assert redrawn <= 3, redrawn
    pj = jax.tree.map(jnp.asarray, p_np)
    pt = tree_map(lambda a: torch.from_numpy(np.array(a)), p_np)
    oj, aj = RL.moe_apply(pj, cfg_r, jnp.asarray(x))
    ot, at = L.moe_apply(pt, cfg_p, torch.from_numpy(x))
    groups = x.reshape(-1, G, d) if G else x
    idx_j, counts_j = _ref_routing(p_np["router"], groups, k, E)
    probs, idx_t, gates, pos, counts_t = L.moe_route(
        pt, cfg_p, torch.from_numpy(groups))
    assert np.array_equal(idx_t.numpy(), idx_j)
    assert np.array_equal(counts_t.numpy(), counts_j)
    assert float(at["moe_drop_frac"]) == float(aj["moe_drop_frac"])
    C = L.moe_capacity(cfg_p, groups.shape[1])
    assert C == max(4, min(int(np.ceil(groups.shape[1] * k / E * cf)),
                           groups.shape[1] * k))
    dropped = float(aj["moe_drop_frac"])
    assert (dropped > 0) == (cf < 8), dropped
    assert dropped == pytest.approx(
        1 - np.minimum(counts_j, C).sum() / counts_j.sum(), rel=1e-6)
    # the queue positions count each expert's earlier choices in GShard
    # order: every expert's positions are 0..count-1, first choices first
    for g in range(groups.shape[0]):
        for e in range(E):
            sel = idx_t[g] == e
            got = np.sort(pos[g][sel].numpy())
            assert np.array_equal(got, np.arange(int(counts_t[g, e])))
    close(gates.sum(-1), np.ones(groups.shape[:2]), LAYER_TOL, "gates")
    close(ot, oj, LAYER_TOL, "out")
    close(at["moe_lb_loss"], aj["moe_lb_loss"], LAYER_TOL, "lb loss")


def test_moe_apply_gradients_match_jax_grad():
    cfg_r, cfg_p = cfgs("qwen2_moe_a2p7b", moe_capacity_factor=1.25)
    p_np = ref_tree(cfg_r)["layers"][0]["moe"]
    x, _ = _guarded_x(p_np["router"], (2, 48, cfg_r.d_model),
                      cfg_r.moe_top_k, seed=6, tilt=1.5)
    w = np.random.default_rng(7).standard_normal(x.shape).astype(np.float32)

    def ref(p, xx):
        out, aux = RL.moe_apply(p, cfg_r, xx)
        return jnp.sum(out * w) + aux["moe_lb_loss"]

    gj = jax.grad(ref, argnums=(0, 1))(jax.tree.map(jnp.asarray, p_np),
                                       jnp.asarray(x))
    pt = tree_map(lambda a: torch.from_numpy(np.array(a)).requires_grad_(True),
                  p_np)
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = L.moe_apply(pt, cfg_p, xt)
    assert float(aux["moe_drop_frac"]) > 0
    loss = (out * torch.from_numpy(w)).sum() + aux["moe_lb_loss"]
    got = torch.autograd.grad(loss, tree_leaves(pt) + [xt])
    want = jax.tree_util.tree_leaves(gj[0]) + [gj[1]]
    for g, wnt in zip(got, [np.asarray(a) for a in want]):
        err = float(np.abs(g.numpy() - wnt).max()) / (1 + np.abs(wnt).max())
        assert err < GRAD_TOL, err


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


TRAIN_CASES = {
    "cf8_none_list": ("qwen2_moe_a2p7b", 8.0, dict(remat="none")),
    "cf1.25_full_stacked": ("qwen2_moe_a2p7b", 1.25,
                            dict(remat="full", scan_layers=True)),
    "grok_cf1.25_block_stacked": ("grok1_314b", 1.25,
                                  dict(remat="block", scan_layers=True)),
}


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_forward_train_loss_and_gradients_match_value_and_grad(case, margins):
    name, cf, over = TRAIN_CASES[case]
    cfg_r, cfg_p = cfgs(name, moe_capacity_factor=cf, **over)
    tree = ref_tree(cfg_r, tilt=1.0)
    params = lm.load_reference_params(tree, cfg_p, device="cpu")
    batch = lambda seed: {k: np.asarray(v) for k, v in  # noqa: E731
                          ref_make_batch(cfg_r, 2, 40, seed=seed).items()}
    b = batch(guarded_seed(
        lambda s: lm.forward_train(params, cfg_p, t_batch(batch(s))), margins, 1))
    loss_r, met_r, g_r = ref_loss_and_grads(cfg_r, tree, b)
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss_p, met_p = lm.forward_train(leaves, cfg_p, t_batch(b))
    g_p = torch.autograd.grad(loss_p, tree_leaves(leaves))
    assert_margin(margins)
    assert sorted(met_p) == sorted(met_r) == ["ce_loss", "moe_drop_frac",
                                              "moe_lb_loss"]
    assert abs(float(loss_p.detach()) - loss_r) <= LOSS_RTOL * abs(loss_r)
    assert float(met_p["moe_drop_frac"]) == float(met_r["moe_drop_frac"])
    assert (float(met_r["moe_drop_frac"]) > 0) == (cf < 8)
    close(met_p["moe_lb_loss"], met_r["moe_lb_loss"], LAYER_TOL)
    check_grads(cfg_p, g_p, g_r)


PREFILL_CASES = {
    "cf8_list": ("qwen2_moe_a2p7b", 8.0, False),
    "cf1.25_stacked": ("qwen2_moe_a2p7b", 1.25, True),
    "grok_cf1.25_list": ("grok1_314b", 1.25, False),
}


@pytest.mark.parametrize("case", list(PREFILL_CASES))
def test_prefill_and_four_decode_steps_match_reference(case, margins):
    """Prefill groups per row (tokens drop at 1.25), decode groups the
    batch: one group of B tokens a step, C = max(4, ...)."""
    name, cf, stacked = PREFILL_CASES[case]
    cfg_r, cfg_p, pj, pt = models(name, dict(tilt=1.0),
                                  moe_capacity_factor=cf, scan_layers=stacked)
    B, S, max_seq = 3, 24, 32
    draw = lambda seed, shape: np.random.default_rng(seed).integers(  # noqa: E731
        1, cfg_r.vocab_size, shape).astype(np.int32)

    def port_run(seed):
        _, st = lm.forward_prefill(pt, cfg_p,
                                   {"tokens": torch.from_numpy(draw(seed, (B, S)))},
                                   max_seq=max_seq)
        for step in range(4):
            lm.forward_decode(pt, cfg_p, torch.from_numpy(
                draw(100 * seed + 10 + step, (B, 1))), st)

    seed = guarded_seed(port_run, margins, 1)
    toks = draw(seed, (B, S))
    lj, sj = rlm.forward_prefill(pj, cfg_r, {"tokens": jnp.asarray(toks)},
                                 max_seq=max_seq)
    lt, st = lm.forward_prefill(pt, cfg_p, {"tokens": torch.from_numpy(toks)},
                                max_seq=max_seq)
    close(lt, lj, TOL, f"{case} prefill")
    # the prefill's drop fraction, as the train path reports it
    _, met = rlm.forward_train(pj, cfg_r, {"tokens": jnp.asarray(toks),
                                          "labels": jnp.asarray(toks)})
    assert (float(met["moe_drop_frac"]) > 0) == (cf < 8)
    dec = jax.jit(lambda p, t, s: rlm.forward_decode(p, cfg_r, t, s))
    for step in range(4):
        tok = draw(100 * seed + 10 + step, (B, 1))
        lj, sj = dec(pj, jnp.asarray(tok), sj)
        lt, st = lm.forward_decode(pt, cfg_p, torch.from_numpy(tok), st)
        close(lt, lj, TOL, f"{case} step {step}")
    assert_margin(margins)
    assert int(st.pos) == int(sj.pos) == S + 4
    for label, a, b in state_pairs(st, sj):
        assert tuple(a.shape) == b.shape, label
        close(a, b, TOL, f"{case} state {label}")


def test_score_last_matches_reference_prefill_logits(margins):
    cfg_r, cfg_p, pj, pt = models("qwen2_moe_a2p7b", dict(tilt=1.0),
                                  moe_capacity_factor=1.25)
    draw = lambda seed: np.random.default_rng(seed).integers(  # noqa: E731
        1, cfg_r.vocab_size, (3, 20)).astype(np.int32)
    toks = draw(guarded_seed(
        lambda s: lm.score_last(pt, cfg_p, torch.from_numpy(draw(s))), margins, 2))
    lj, _ = rlm.forward_prefill(pj, cfg_r, {"tokens": jnp.asarray(toks)},
                                max_seq=20)
    got = lm.score_last(pt, cfg_p, torch.from_numpy(toks))
    assert tuple(got.shape) == (3, 1, cfg_r.vocab_size)
    close(got, lj, TOL)
    assert_margin(margins)


def test_stream_engine_on_the_moe_matches_reference(margins):
    """The serve path's lean step (``score_last``) on the reduced
    Qwen2-MoE: the same events give the same sink records."""
    from test_torch_stream_engine import MARGIN as TOKEN_MARGIN
    from test_torch_stream_engine import _events, _margins, _ref_events

    kw = dict(max_batch_events=8, max_seq=32, seq_bucket_count=2)
    cfg_r, cfg_p = cfgs("qwen2_moe_a2p7b")
    ref = RefStreamEngine(cfg_r, seed=0, econf=RefEngineConfig(**kw))
    tree = jax.tree.map(np.asarray, ref.params)

    def engine():
        port = StreamEngine(cfg_p, seed=0, econf=EngineConfig(**kw),
                            device="cpu")
        port.params = lm.load_reference_params(tree, cfg_p, "cpu")
        return port

    def port_run(seed):
        eng = engine()
        eng.buffer.put(_events(19, seed=seed))
        for _ in range(3):
            eng.process_batch(5.0)

    evs = _events(19, seed=guarded_seed(port_run, margins))
    port = engine()
    ref.buffer.put(_ref_events(evs))
    port.buffer.put(evs)
    for _ in range(3):
        peek = [e for _, e in list(ref.buffer._q)[:8]]
        seq = ref._bucket_seq(max(e.tokens for e in peek))
        assert (_margins(ref, ref._tokens_of(peek, seq)) > TOKEN_MARGIN).all()
        rrep, prep = ref.process_batch(5.0), port.process_batch(5.0)
        assert prep.n_events == rrep.n_events
        assert prep.padding_frac == rrep.padding_frac
    assert_margin(margins)
    assert port.sink.rows == ref.sink.rows and len(port.sink.rows) == 19
    assert port.jit_compiles == ref.jit_compiles


# ---------------------------------------------------------------------------
# The steps
# ---------------------------------------------------------------------------


def test_train_prefill_and_decode_steps_match_the_reference_composition(
        margins):
    """One ``make_train_step`` step (the reference's value_and_grad +
    adamw), then ``make_prefill_step`` and three ``make_decode_step``
    steps against the jitted reference composition, on the stacked tree."""
    cfg_r, cfg_p, pj, pt = models("qwen2_moe_a2p7b", dict(tilt=1.0),
                                  moe_capacity_factor=1.25, scan_layers=True)
    B, S = 2, 16
    batch = lambda seed: {k: np.asarray(v) for k, v in  # noqa: E731
                          ref_make_batch(cfg_r, B, S, seed=seed).items()}

    def port_run(seed):
        toks = torch.from_numpy(np.array(batch(seed)["tokens"]))
        lm.forward_train(pt, cfg_p, {"tokens": toks, "labels": toks})
        logits, st = lm.forward_prefill(pt, cfg_p, {"tokens": toks},
                                        max_seq=S + 64)
        for _ in range(3):
            tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
            logits, st = lm.forward_decode(pt, cfg_p, tok, st)

    b = batch(guarded_seed(port_run, margins, 3))
    r_opt = ropt.adamw()

    def ref_step(p, o, bb):
        (loss, m), g = jax.value_and_grad(
            lambda pp: rlm.forward_train(pp, cfg_r, bb), has_aux=True)(p)
        np_, no = r_opt.update(g, o, p)
        return np_, no, m

    rp, ro, rm = jax.jit(ref_step)(pj, r_opt.init(pj), b)
    train = make_train_step(cfg_p, optim.adamw(), InputShape("t", S, B, "train"),
                            device="cpu")
    assert sorted(train.arg_specs[2]) == ["labels", "mask", "tokens"]
    pp, po, pm = train.fn(pt, optim.adamw().init(pt), t_batch(b))
    assert abs(float(pm["ce_loss"]) - float(rm["ce_loss"])) <= \
        LOSS_RTOL * abs(float(rm["ce_loss"]))
    assert float(pm["moe_drop_frac"]) == float(rm["moe_drop_frac"])
    # AdamW's first step is ~lr·sign(g): held as tests/test_torch_train.py
    # holds three steps (elements off by more than 1e-6 of the leaf's scale
    # are under 1e-3 of it, and within a quarter of its largest update)
    for g, w, p0 in zip(tree_leaves(pp), tree_leaves(lm.load_reference_params(
            jax.tree.map(np.asarray, rp), cfg_p, device="cpu")),
            tree_leaves(pt)):
        d = (g - w).abs()
        assert float((d > 1e-6 * (1 + float(w.abs().max()))).float().mean()) \
            < 1e-3
        assert float(d.max()) <= 0.25 * float((w - p0).abs().max())

    pre = make_prefill_step(cfg_p, InputShape("p", S, B, "prefill"),
                            device="cpu")
    assert pre.meta["max_seq"] == S + 64
    lj, sj = jax.jit(lambda p, bb: rlm.forward_prefill(p, cfg_r, bb,
                                                       max_seq=S + 64))(
        pj, {"tokens": jnp.asarray(b["tokens"])})
    lt, st = pre.fn(pt, {"tokens": torch.from_numpy(np.array(b["tokens"]))})
    close(lt, lj, TOL, "prefill")
    dec = make_decode_step(cfg_p, InputShape("d", S + 64, B, "decode"),
                           device="cpu")
    ref_dec = jax.jit(lambda p, t, s: rlm.forward_decode(p, cfg_r, t, s))
    tok_j = jnp.argmax(lj[:, -1, :], axis=-1).astype(jnp.int32)[:, None]
    tok_t = torch.from_numpy(np.array(tok_j))
    for step in range(3):
        logits_j, sj = ref_dec(pj, tok_j, sj)
        tok_t, st = dec.fn(pt, tok_t, st)
        top2 = np.sort(np.asarray(logits_j[:, -1]), axis=-1)[:, -2:]
        assert ((top2[:, 1] - top2[:, 0]) > 1e-3).all(), (step, top2)
        tok_j = jnp.argmax(logits_j[:, -1, :], axis=-1).astype(jnp.int32)[:, None]
        assert np.array_equal(tok_t.numpy(), np.asarray(tok_j))
    assert_margin(margins)


@pytest.mark.parametrize("arch", ["qwen2_moe_a2p7b", "internvl2_26b",
                                  "whisper_large_v3"])
def test_train_launcher_runs_the_family_through_its_drill(arch, tmp_path):
    """``launch/train.py`` takes the moe, vlm and audio archs as it takes
    the others: the failure drill resumes from the step-2 checkpoint and
    its last steps' losses equal an uninterrupted run's."""
    import io
    from repro_torch.launch import train as ptrain

    def launch(sub, *extra):
        with contextlib.redirect_stdout(io.StringIO()):
            return ptrain.main(["--arch", arch, "--device", "cpu", "--steps",
                                "4", "--batch", "2", "--seq", "16",
                                "--ckpt-every", "2", "--ckpt-dir",
                                str(tmp_path / sub), "--log-every", "1",
                                *extra])

    drill = launch("drill", "--inject-failure", "3")
    plain = launch("plain")
    assert drill["resumed_at"] == [2] and drill["steps"] == 4
    assert np.isfinite(drill["losses"]).all()
    assert drill["losses"][-2:] == plain["losses"][-2:]
