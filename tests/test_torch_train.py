"""The port's training step against the reference's, on the CPU.

Both sides start from the same numpy state: the reference's parameter tree
(its init, with the degenerate leaves perturbed from a seed: norm scales,
RWKV-6's ``w_bias`` / ``u_bonus`` / token-shift mixes, so every gradient
path carries signal) and, for the optimizers, seeded gradients and moments,
carried into the port by ``load_reference_params`` /
``load_reference_opt_state``. Everything runs in f32 unless a case names
bf16.

Tolerances:
- optimizer updates: rtol 1e-6 on f32 leaves, with an atol of 1e-6 of the
  leaf's largest value (the same f32 operations in the same order; XLA may
  contract a multiply-add, one f32 rounding, which shows relatively only
  where ``p - lr·upd`` cancels to near zero). bf16 leaves (bf16 moments,
  bf16 parameters) within one bf16 rounding (rtol 2^-8, atol 2^-8 of the
  leaf's largest value): values one f32 rounding apart before the cast can
  land on either side of a bf16 rounding boundary; an f32 parameter moved
  by bf16 moments within 2^-7 of its step;
- ``forward_train``: loss rtol 1e-5; each gradient leaf within
  1e-5 · (1 + max |g|) of the reference's (measured: ~3e-7 dense, ~5e-6
  RWKV-6, whose chunked recurrence sums ``exp`` products in another order);
- three train steps: loss rtol 1e-5 each; parameters within 1e-6 ·
  (1 + max |p|) of the reference's but for fewer than 1e-3 of a leaf's
  elements, and those within a quarter of the leaf's largest 3-step update.
  AdamW divides each gradient element by its own size (its first step is
  ~lr·sign(g)), so an element whose gradient is as small as the two
  sums' rounding moves by a share of lr, not of its rounding; measured:
  at most 3.9e-4 of a leaf's elements, 0.10 of the update;
- the port against itself (remat modes, the drill) is bitwise: the same
  ops on the same CPU; ``accum_steps=2`` against 1 within 1e-6 (the mean
  over two halves against the mean over the whole batch).

The reference's ``make_train_step`` does not trace on this JAX (its
sharding constraint refers to a mesh axis that is not Auto), so the
reference side is the composition it wraps: ``jax.value_and_grad(
forward_train)`` then ``adamw().update``, under ``jax.jit``.
"""
import contextlib
import dataclasses
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro import optim as ropt  # noqa: E402
from repro.checkpoint import store as rstore  # noqa: E402
from repro.data.synthetic import make_batch as ref_make_batch  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro_torch import configs, optim  # noqa: E402
from repro_torch.checkpoint import CheckpointStore  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.data.synthetic import batch_spec, make_batch  # noqa: E402
from repro_torch.distribution import make_train_step  # noqa: E402
from repro_torch.launch import train as ptrain  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.utils import tree_leaves, tree_map  # noqa: E402

GRAD_TOL = 1e-5
LOSS_RTOL = 1e-5
OPT_RTOL = 1e-6
BF16_RTOL = 2.0 ** -8


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


def _perturb(tree, seed):
    rng = np.random.default_rng(seed)

    def one(path, a):
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

    return jax.tree_util.tree_map_with_path(one, tree)


def _ref_params(cfg_r, seed=0):
    tree = jax.tree.map(np.asarray,
                        rlm.init_params(cfg_r, jax.random.PRNGKey(seed)))
    return _perturb(tree, seed)


def _np_batch(cfg_r, B, S, seed=1):
    return {k: np.asarray(v) for k, v in
            ref_make_batch(cfg_r, B, S, seed=seed).items()}


def _t_batch(b):
    return {k: torch.from_numpy(v.copy()) for k, v in b.items()}


def _port(tree, cfg_p):
    return lm.load_reference_params(tree, cfg_p, device="cpu")


def _np32(x):
    x = x.detach() if isinstance(x, torch.Tensor) else x
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _leaf_err(got, want):
    """max |got - want| over 1 + max |want|."""
    g, w = _np32(got), _np32(want)
    return float(np.abs(g - w).max()) / (1.0 + float(np.abs(w).max()))


def _port_grads(params, cfg_p, batch):
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, _ = lm.forward_train(leaves, cfg_p, batch)
    return loss.detach(), torch.autograd.grad(loss, tree_leaves(leaves))


def _ref_loss_and_grads(cfg_r, tree, b):
    fn = jax.jit(jax.value_and_grad(
        lambda p, bb: rlm.forward_train(p, cfg_r, bb), has_aux=True))
    (loss, _), g = fn(jax.tree.map(jnp.asarray, tree), b)
    return float(loss), g


# ---------------------------------------------------------------------------
# Optimizers
# ---------------------------------------------------------------------------


def _opt_state_np(ref_opt, params_np, seed):
    """The reference optimizer's state with seeded moments and count 3."""
    rng = np.random.default_rng(seed)
    st = jax.tree.map(np.asarray, ref_opt.init(
        jax.tree.map(jnp.asarray, params_np)))

    def fill(path, a):
        key = path[0].key
        if key == "count":
            return np.asarray(3, np.int32)
        m = 1e-3 * rng.standard_normal(a.shape)
        if key == "nu":
            m = np.abs(m) * 1e-3
        return np.asarray(jnp.asarray(m, jnp.float32).astype(a.dtype))

    return jax.tree_util.tree_map_with_path(fill, st)


OPT_CASES = {
    "adamw_list_f32": ("adamw", dict(lr=3e-4), dict(), "float32"),
    "adamw_stacked_f32": ("adamw", dict(lr=3e-4), dict(scan_layers=True),
                          "float32"),
    "adamw_list_bf16_moments": ("adamw", dict(moment_dtype="bfloat16"),
                                dict(), "float32"),
    "adamw_stacked_bf16": ("adamw", dict(moment_dtype="bfloat16"),
                           dict(scan_layers=True, dtype="bfloat16"),
                           "bfloat16"),
    "sgd_list": ("sgd", dict(grad_clip=0.5), dict(), "float32"),
    "rmsprop_clip": ("rmsprop", dict(grad_clip=0.05), dict(), "float32"),
}


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_optimizer_update_matches_reference(case):
    name, kw, over, dt = OPT_CASES[case]
    cfg_r, cfg_p = _cfgs("smollm_135m", **over)
    params_np = _ref_params(cfg_r)
    rng = np.random.default_rng(7)
    grads_np = jax.tree.map(
        lambda a: np.asarray(jnp.asarray(
            0.05 * rng.standard_normal(a.shape), jnp.float32).astype(a.dtype)),
        params_np)
    r_opt, p_opt = ropt.optimizers.get(name, **kw), optim.get(name, **kw)
    state_np = _opt_state_np(r_opt, params_np, 8)
    want_p, want_s = jax.jit(r_opt.update)(
        *(jax.tree.map(jnp.asarray, t) for t in (grads_np, state_np,
                                                 params_np)))
    got_p, got_s = p_opt.update(
        _port(grads_np, cfg_p), lm.load_reference_opt_state(
            state_np, cfg_p, device="cpu"), _port(params_np, cfg_p))
    pairs = list(zip(tree_leaves(got_p), tree_leaves(_port(
        jax.tree.map(np.asarray, want_p), cfg_p))))
    for k in ("mu", "nu"):
        if k in want_s:
            pairs += list(zip(tree_leaves(got_s[k]), tree_leaves(_port(
                jax.tree.map(np.asarray, want_s[k]), cfg_p))))
    bf16_moments = kw.get("moment_dtype") == "bfloat16"
    olds = tree_leaves(_port(params_np, cfg_p))
    for i, (got, want) in enumerate(pairs):
        assert got.dtype == want.dtype and got.shape == want.shape
        w = _np32(want)
        if got.dtype == torch.bfloat16:
            atol = BF16_RTOL * float(np.abs(w).max())
        elif bf16_moments and i < len(olds):
            # an f32 parameter moved by bf16 moments: a moment one bf16
            # rounding apart moves the step by 2^-8 of its size
            atol = 2 * BF16_RTOL * float(np.abs(w - _np32(olds[i])).max())
        else:
            atol = OPT_RTOL * float(np.abs(w).max())
        rtol = BF16_RTOL if got.dtype == torch.bfloat16 else OPT_RTOL
        np.testing.assert_allclose(_np32(got), w, rtol=rtol, atol=atol,
                                   err_msg=case)
    assert int(got_s["count"]) == int(want_s["count"]) == 4
    if case == "adamw_stacked_f32":
        # stacked (L, d) norm scales count as matrices: decayed even at a
        # zero gradient; the list layout's (d,) scales are not
        zero = tree_map(torch.zeros_like, _port(grads_np, cfg_p))
        st = p_opt.init(_port(params_np, cfg_p))
        p0 = _port(params_np, cfg_p)
        p1, _ = p_opt.update(zero, st, p0)
        assert not torch.equal(p1["layers"]["norm1"]["scale"],
                               p0["layers"]["norm1"]["scale"])
        assert torch.equal(p1["final_norm"]["scale"], p0["final_norm"]["scale"])


def test_clip_by_global_norm_matches_reference():
    rng = np.random.default_rng(3)
    tree = {"a": rng.standard_normal((7, 5)).astype(np.float32),
            "b": [rng.standard_normal(11).astype(np.float32),
                  rng.standard_normal((2, 3)).astype(np.float32)]}
    for max_norm in (0.5, 1e3):
        want = ropt.clip_by_global_norm(jax.tree.map(jnp.asarray, tree),
                                        max_norm)
        got = optim.clip_by_global_norm(
            tree_map(lambda a: torch.from_numpy(np.array(a)), tree),
            max_norm)
        for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       rtol=OPT_RTOL, atol=0)


# ---------------------------------------------------------------------------
# Layer backward passes
# ---------------------------------------------------------------------------


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _vjp_pair(f_ref, f_port, args, seed=11):
    """The gradients of <f(args), w> for a seeded cotangent w, both sides."""
    out = jax.eval_shape(f_ref, *(jnp.asarray(a) for a in args))
    w = _x(out.shape, seed)
    gr = jax.jit(jax.grad(lambda *a: jnp.sum(f_ref(*a) * w),
                          argnums=tuple(range(len(args)))))(
        *(jnp.asarray(a) for a in args))
    ts = [torch.from_numpy(a.copy()).requires_grad_(True) for a in args]
    y = f_port(*ts)
    gp = torch.autograd.grad((y * torch.from_numpy(w)).sum(), ts)
    return gr, gp


LAYER_CASES = ["attention_chunked", "attention_chunked_ragged",
               "attention_naive", "time_mix", "channel_mix", "rmsnorm"]


@pytest.mark.parametrize("case", LAYER_CASES)
def test_layer_gradients_match_jax_grad(case):
    if case.startswith("attention"):
        impl = "naive" if case.endswith("naive") else "chunked"
        S = 40 if case.endswith("ragged") else 48
        args = [_x((2, S, 4, 16), 1), _x((2, S, 2, 16), 2),
                _x((2, S, 2, 16), 3)]
        kw = dict(causal=True, chunk=16, impl=impl)
        f_ref = lambda q, k, v: RL.attention_core(q, k, v, **kw)
        f_port = lambda q, k, v: L.attention_core(q, k, v, **kw)
    elif case == "rmsnorm":
        args = [_x((3, 9, 32), 1), 1 + 0.1 * _x((32,), 2)]
        f_ref = lambda x, s: RL.rmsnorm({"scale": s}, x, 1e-5)
        f_port = lambda x, s: L.rmsnorm({"scale": s}, x, 1e-5)
    else:
        cfg_r, cfg_p = _cfgs("rwkv6_7b", wkv_chunk=8)
        p_np = _ref_params(cfg_r)["layers"][0]
        keys = (["wr", "wk", "wv", "wg", "w_lora_a", "w_lora_b", "w_bias",
                 "u_bonus", "mix_rkvwg", "wo"] if case == "time_mix"
                else ["mix_cm", "cm_k", "cm_v", "cm_r"])
        args = [_x((2, 20, cfg_r.d_model), 4)] + [p_np[k] for k in keys]
        rest = {k: v for k, v in p_np.items() if k not in keys}
        ref_fn = RL.rwkv6_time_mix if case == "time_mix" \
            else RL.rwkv6_channel_mix
        port_fn = L.rwkv6_time_mix if case == "time_mix" \
            else L.rwkv6_channel_mix
        rest_t = tree_map(lambda a: torch.from_numpy(np.array(a)), rest)
        f_ref = lambda x, *ws: ref_fn({**rest, **dict(zip(keys, ws))},
                                      cfg_r, x)[0]
        f_port = lambda x, *ws: port_fn({**rest_t, **dict(zip(keys, ws))},
                                        cfg_p, x)[0]
    gr, gp = _vjp_pair(f_ref, f_port, args)
    for i, (w, g) in enumerate(zip(gr, gp)):
        assert torch.isfinite(g).all(), f"{case}: arg {i} non-finite"
        assert _leaf_err(g, w) < GRAD_TOL, (case, i, _leaf_err(g, w))


# ---------------------------------------------------------------------------
# forward_train under autograd, remat
# ---------------------------------------------------------------------------


GRAD_CASES = {
    "dense_list": ("smollm_135m", dict()),
    "dense_stacked_block": ("smollm_135m", dict(scan_layers=True,
                                                remat="block",
                                                attn_chunk=16)),
    "qwen2_bias_full": ("qwen2_7b", dict(remat="full")),
    "ssm_list": ("rwkv6_7b", dict()),
    "ssm_stacked_block": ("rwkv6_7b", dict(scan_layers=True,
                                           remat="block")),
}


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_forward_train_gradients_match_value_and_grad(case):
    name, over = GRAD_CASES[case]
    cfg_r, cfg_p = _cfgs(name, **over)
    tree = _ref_params(cfg_r)
    b = _np_batch(cfg_r, 2, 40)
    loss_r, g_r = _ref_loss_and_grads(cfg_r, tree, b)
    loss_p, g_p = _port_grads(_port(tree, cfg_p), cfg_p, _t_batch(b))
    assert abs(float(loss_p) - loss_r) <= LOSS_RTOL * abs(loss_r)
    want = tree_leaves(_port(jax.tree.map(np.asarray, g_r), cfg_p))
    assert len(want) == len(g_p)
    for g, w in zip(g_p, want):
        assert g.shape == w.shape and torch.isfinite(g).all()
        assert _leaf_err(g, w) < GRAD_TOL, (case, _leaf_err(g, w))


@pytest.mark.parametrize("name", ["smollm_135m", "rwkv6_7b"])
def test_remat_modes_give_the_same_loss_and_gradients(name):
    cfg_r, _ = _cfgs(name, scan_layers=True, attn_chunk=16)
    tree = _ref_params(cfg_r)
    b = _t_batch(_np_batch(cfg_r, 2, 40))
    out = {}
    for remat in ("none", "block", "full"):
        _, cfg_p = _cfgs(name, scan_layers=True, attn_chunk=16, remat=remat)
        out[remat] = _port_grads(_port(tree, cfg_p), cfg_p, b)
    for remat in ("block", "full"):
        assert torch.equal(out[remat][0], out["none"][0]), remat
        for g, w in zip(out[remat][1], out["none"][1]):
            assert torch.equal(g, w), remat


def test_remat_modes_recompute_what_the_reference_policies_drop():
    """The ops the backward pass runs, by mode: "block" keeps the weight
    products (no mm recomputed, as "none") and recomputes attention's
    batched products, the softmax's exp, the norms and the activation;
    "full" recomputes the weight products too."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            self.n[name] = self.n.get(name, 0) + 1
            return func(*args, **(kwargs or {}))

    runs = {}
    for remat in ("none", "block", "full"):
        _, cfg_p = _cfgs("smollm_135m", scan_layers=True, remat=remat)
        params = lm.init_params(cfg_p, torch.Generator().manual_seed(0),
                                device="cpu")
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        toks = torch.randint(0, cfg_p.vocab_size, (2, 64), dtype=torch.int32,
                             generator=torch.Generator().manual_seed(1))
        y = lm._backbone(leaves, cfg_p, leaves["embed"][toks])[0].sum()
        with Count() as c:
            torch.autograd.grad(y, tree_leaves(leaves["layers"]))
        runs[remat] = {k: c.n.get(k, 0) for k in ("mm", "bmm", "exp",
                                                    "silu")}
    n = cfg_p.num_layers
    none, block, full = runs["none"], runs["block"], runs["full"]
    assert block["mm"] == none["mm"] and full["mm"] > block["mm"]
    assert block["bmm"] == none["bmm"] + 2 * n == full["bmm"]
    assert none["exp"] == none["silu"] == 0
    assert block["exp"] == full["exp"] == 2 * n
    assert block["silu"] == full["silu"] == n


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------


def _ref_step(cfg_r, r_opt):
    def step(p, o, b):
        (loss, m), g = jax.value_and_grad(
            lambda pp: rlm.forward_train(pp, cfg_r, b), has_aux=True)(p)
        np_, no = r_opt.update(g, o, p)
        return np_, no, m

    return jax.jit(step)


@pytest.mark.parametrize("name,over", [
    ("smollm_135m", dict()),
    ("rwkv6_7b", dict(scan_layers=True, remat="block")),
])
def test_three_train_steps_match_the_reference_composition(name, over):
    cfg_r, cfg_p = _cfgs(name, **over)
    tree = _ref_params(cfg_r)
    r_opt = ropt.adamw()
    rs = _ref_step(cfg_r, r_opt)
    rp = jax.tree.map(jnp.asarray, tree)
    ro = r_opt.init(rp)
    bundle = make_train_step(cfg_p, optim.adamw(),
                             InputShape("t", 24, 4, "train"), device="cpu")
    pp = _port(tree, cfg_p)
    po = lm.load_reference_opt_state(jax.tree.map(np.asarray, ro), cfg_p,
                                     device="cpu")
    for i in range(3):
        b = _np_batch(cfg_r, 4, 24, seed=i)
        rp, ro, rm = rs(rp, ro, b)
        pp, po, pm = bundle.fn(pp, po, _t_batch(b))
        lr_, lp = float(rm["ce_loss"]), float(pm["ce_loss"])
        assert abs(lp - lr_) <= LOSS_RTOL * abs(lr_), (i, lp, lr_)
    want = tree_leaves(_port(jax.tree.map(np.asarray, rp), cfg_p))
    start = tree_leaves(_port(tree, cfg_p))
    for g, w, p0 in zip(tree_leaves(pp), want, start):
        d = np.abs(_np32(g) - _np32(w))
        far = d > OPT_RTOL * (1.0 + float(np.abs(_np32(w)).max()))
        assert far.mean() < 1e-3, far.mean()
        assert d.max() <= 0.25 * float(np.abs(_np32(w) - _np32(p0)).max())
    assert int(po["count"]) == int(ro["count"]) == 3


def test_accum_steps_two_matches_one():
    _, cfg_p = _cfgs("smollm_135m")
    params = lm.init_params(cfg_p, torch.Generator().manual_seed(0),
                            device="cpu")
    opt = optim.adamw()
    b = make_batch(cfg_p, 4, 24, seed=5, device="cpu")
    shape = InputShape("t", 24, 4, "train")
    one = make_train_step(cfg_p, opt, shape, device="cpu")
    two = make_train_step(cfg_p, opt, shape, device="cpu", accum_steps=2)
    p1, o1, m1 = one.fn(params, opt.init(params), b)
    p2, o2, m2 = two.fn(params, opt.init(params), b)
    assert abs(float(m1["ce_loss"]) - float(m2["ce_loss"])) < 1e-6
    for a, c in zip(tree_leaves([p1, o1["mu"], o1["nu"]]),
                    tree_leaves([p2, o2["mu"], o2["nu"]])):
        assert _leaf_err(a, c) < 1e-6


def test_step_bundle_specs_and_device_rules():
    _, cfg_p = _cfgs("smollm_135m")
    opt = optim.adamw()
    bundle = make_train_step(cfg_p, opt, InputShape("t", 16, 4, "train"),
                             device="cpu")
    params_s, opt_s, batch_s = bundle.arg_specs
    assert all(t.device.type == "meta" for t in tree_leaves(bundle.arg_specs))
    params = lm.init_params(cfg_p, torch.Generator().manual_seed(0),
                            device="cpu")
    assert [t.shape for t in tree_leaves(params_s)] == \
        [t.shape for t in tree_leaves(params)]
    assert {k: (tuple(v.shape), v.dtype) for k, v in batch_s.items()} == {
        k: (tuple(v.shape), v.dtype) for k, v in
        batch_spec(cfg_p, 4, 16).items()} == {
        "tokens": ((4, 16), torch.int32), "labels": ((4, 16), torch.int32),
        "mask": ((4, 16), torch.float32)}
    assert opt_s["count"].dtype == torch.int32
    with pytest.raises(TypeError, match="DeviceMesh"):
        make_train_step(cfg_p, opt, InputShape("t", 16, 4, "train"),
                        device="cpu", mesh=object())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_train_step(cfg_p, opt, InputShape("t", 16, 4, "train"))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ptrain.main(["--steps", "1"])


# ---------------------------------------------------------------------------
# The launcher and its checkpoints
# ---------------------------------------------------------------------------


def _launch(tmp, *extra):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = ptrain.main(["--device", "cpu", "--steps", "6", "--batch", "2",
                           "--seq", "16", "--ckpt-every", "2",
                           "--ckpt-dir", str(tmp), "--log-every", "1",
                           *extra])
    return res, out.getvalue()


def test_launcher_failure_drill_is_bitwise_equal_to_an_uninterrupted_run(
        tmp_path):
    drill, log = _launch(tmp_path / "drill", "--inject-failure", "3")
    assert drill["resumed_at"] == [2] and "[failure] resumed at step 2" in log
    plain, _ = _launch(tmp_path / "plain")
    assert drill["steps"] == plain["steps"] == 6
    assert drill["losses"][-3:] == plain["losses"][-3:]
    a = CheckpointStore(drill["ckpt_dir"])
    b = CheckpointStore(plain["ckpt_dir"])
    assert a.latest_step() == b.latest_step() == 6
    assert a.leaf_keys() == b.leaf_keys()
    ma = a.restore(_skeleton(a), host=True)[0]
    mb = b.restore(_skeleton(b), host=True)[0]
    for k in ma:
        assert ma[k].dtype == mb[k].dtype and np.array_equal(ma[k], mb[k]), k
    # the restart picks up the latest checkpoint and goes on from there
    more, log = _launch(tmp_path / "plain", "--steps", "8")
    assert more["start"] == 6 and "[resume] restored step 6" in log
    assert more["steps"] == 8


def _skeleton(store):
    """A flat skeleton of a checkpoint's leaves (restore fills it)."""
    return {k: None for k in store.leaf_keys()}


def test_launcher_checkpoint_has_the_reference_layout(tmp_path):
    res, _ = _launch(tmp_path, "--steps", "2")
    got = CheckpointStore(res["ckpt_dir"]).leaf_keys()
    cfg_r = ref_configs.get("smollm_135m", reduced=True)
    rp = rlm.init_params(cfg_r, jax.random.PRNGKey(0), max_seq=16)
    want = set(rstore._flatten({"params": rp,
                                "opt": ropt.adamw().init(rp)}))
    assert got == want


def test_bf16_leaves_round_trip_through_the_store(tmp_path):
    rng = np.random.default_rng(0)
    tree = {"w": torch.from_numpy(rng.standard_normal((3, 5)).astype(
        np.float32)).to(torch.bfloat16),
            "m": torch.from_numpy(rng.standard_normal(4).astype(np.float32)),
            "count": torch.tensor(7, dtype=torch.int32)}
    st = CheckpointStore(tmp_path)
    st.save(1, tree)
    back, step, _ = st.restore(tree)
    assert step == 1
    for k in tree:
        assert back[k].dtype == tree[k].dtype and torch.equal(back[k], tree[k])
    # the reference writes its ml_dtypes bf16 leaves the same way
    ref = rstore.CheckpointStore(tmp_path / "ref")
    ref.save(1, {"w": jnp.asarray(tree["w"].float().numpy()).astype(
        jnp.bfloat16)})
    got, _, _ = CheckpointStore(tmp_path / "ref").restore({"w": None})
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], tree["w"])
