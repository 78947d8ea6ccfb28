"""The LM mesh (``distribution.steps`` with ``mesh=``, DESIGN.md §4) on gloo
ranks on the CPU, against the port's unsharded steps and the reference.

One group of 4 spawned ranks (``spawn``, a ``FileStore`` in a temporary
directory) runs every mesh computation of this file once (``_work``); the
pytest process keeps no process group and runs the reference. Tolerances:

* placements: each rank's block of every parameter of every reduced
  config on (2, 2) and (2, 4) is the index map the reference's
  ``NamedSharding(mesh, spec).devices_indices_map`` gives (a subprocess
  with 8 forced host devices, the mesh built in device order): exact;
* the train step (``accum_steps=2``, SGD at lr 1 and no momentum history,
  so that a step's change is its gradient) on (2, 2) and (1, 4): the loss
  within ``LOSS_RTOL`` 1e-5 and each gradient leaf within ``GRAD_TOL``
  1e-5 of 1 + its largest value (``tests/test_torch_train.py``'s), against
  the port's unsharded step and against the reference's composition
  (``jax.value_and_grad`` of ``lm.forward_train`` on each micro-batch);
* prefill and decode on (2, 2) and (1, 4): logits and every leaf of the
  final state within rtol / atol 1e-4, greedy tokens equal
  (``tests/test_torch_decode.py``'s), against the unsharded steps and the
  reference's ``forward_prefill`` / ``forward_decode``;
* the split-K decode (batch 1 on (4, 1), positions written on each side
  of every block boundary), ``ep=True`` on qwen2-moe, a padded config
  (smollm's 9 / 3 heads at TP 2) against the reference's padded config run
  unsharded, at the same tolerances;
* ``restore(shardings=)`` from (2, 2) onto (4, 1) and onto no mesh:
  bitwise; the train launcher on (2, 2) with the drill, resumed onto
  (4, 1): every step's loss within ``LOSS_RTOL`` of the one-process run.
"""
import dataclasses
import itertools
import json
import os
import queue
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.distribution import sharding as ref_sh  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.distribution import sharding as sh  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import lm  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-5
TOL = dict(rtol=1e-4, atol=1e-4)
JOIN_S = 600
WORLD = 4
#: (arch, mesh, config overrides) of the train, prefill and decode cases
TRAIN_CASES = (("qwen2_7b", (2, 2)), ("rwkv6_7b", (1, 4)),
               ("zamba2_2p7b", (2, 2)), ("whisper_large_v3", (1, 4)),
               ("internvl2_26b", (2, 2)))
SERVE_CASES = (("qwen2_7b", (2, 2)), ("qwen2_7b", (1, 4)),
               ("rwkv6_7b", (2, 2)), ("zamba2_2p7b", (1, 4)),
               ("whisper_large_v3", (2, 2)), ("internvl2_26b", (1, 4)))
REF_TRAIN = ("qwen2_7b", "rwkv6_7b")
REF_SERVE = (("qwen2_7b", (2, 2)), ("zamba2_2p7b", (1, 4)))
B, S, STEPS = 4, 8, 3
#: split-K: a prompt of 7 and 10 steps over 32 positions in blocks of 8
SPLIT_P, SPLIT_MAX, SPLIT_STEPS = 7, 32, 10
PADDED = dict(num_heads=9, num_kv_heads=3)


def _cfgs(name, **over):
    r = ref_configs.reduce_config(ref_configs.get(name), **over)
    p = configs.reduce_config(configs.get(name), **over)
    assert dataclasses.asdict(r) == dataclasses.asdict(p)
    return r, p


def _ref_tree(cfg_r, seed=0):
    """The reference's parameters with biases, norm scales and the RWKV
    decay terms moved off their initial constants."""
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


def _batch(cfg, Bn, Sn, seed):
    from repro.data.synthetic import make_batch

    return {k: np.asarray(v) for k, v in make_batch(cfg, Bn, Sn,
                                                    seed=seed).items()}


def _prompt(cfg, Bn, Sn, seed):
    b = _batch(cfg, Bn, Sn, seed)
    return {k: v for k, v in b.items() if k not in ("labels", "mask")}


# ---------------------------------------------------------------- the ranks
def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _host(x):
    """A tree of (D)Tensors as numpy arrays, DTensors taken whole."""
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_host(v) for v in x)
    if isinstance(x, torch.Tensor):
        if hasattr(x, "full_tensor"):
            x = x.full_tensor()
        return x.detach().float().numpy() if x.is_floating_point() \
            else x.detach().numpy()
    return x


def _mesh(shape):
    from repro_torch.launch.mesh import make_local_mesh

    return make_local_mesh(*shape)


def _train(cfg, tree, batch, mesh, ep=False):
    """One step at lr 1 (SGD, first step): (loss, gradient leaves)."""
    from repro_torch import optim
    from repro_torch.configs.base import InputShape
    from repro_torch.distribution.steps import make_train_step
    from repro_torch.utils import tree_leaves

    Bn, Sn = batch["tokens"].shape
    opt = optim.sgd(lr=1.0)
    bundle = make_train_step(cfg, opt, InputShape("t", Sn, Bn, "train"),
                             accum_steps=2, device="cpu", mesh=mesh, ep=ep)
    params = lm.load_reference_params(tree, cfg, device="cpu")
    state = opt.init(params)
    b = _t(batch)
    if mesh is not None:
        params = sh.distribute_tree(params, bundle.meta["pspecs"], mesh)
        state = sh.distribute_tree(state, bundle.meta["ospecs"], mesh)
        b = sh.distribute_tree(b, bundle.meta["bspecs"], mesh)
    new, _, met = bundle.fn(params, state, b)
    grads = [a - c for a, c in zip(_host(tree_leaves(params)),
                                   _host(tree_leaves(new)))]
    return float(met["ce_loss"]), grads


def _serve(cfg, tree, prompt, mesh, ep=False, max_seq=None, steps=STEPS,
           split=False):
    """Prefill then ``steps`` greedy steps: (prefill logits, tokens (B,
    1 + steps), the final state's leaves)."""
    from repro_torch.configs.base import InputShape
    from repro_torch.distribution.steps import (make_decode_step,
                                                make_prefill_step)
    from repro_torch.utils import tree_leaves

    Bn, Sn = prompt["tokens"].shape
    pre = make_prefill_step(cfg, InputShape("p", Sn, Bn, "prefill"),
                            max_seq=max_seq, device="cpu",
                            mesh=None if split else mesh, ep=ep)
    dec = make_decode_step(cfg, InputShape("d", pre.meta["max_seq"], Bn,
                                           "decode"), device="cpu",
                           mesh=mesh, ep=ep)
    params = lm.load_reference_params(tree, cfg, device="cpu")
    b = _t(prompt)
    if mesh is not None:
        dparams = sh.distribute_tree(params, dec.meta["pspecs"], mesh)
    if mesh is not None and not split:
        logits, state = pre.fn(
            sh.distribute_tree(params, pre.meta["pspecs"], mesh),
            sh.distribute_tree(b, pre.meta["bspecs"], mesh))
    else:
        logits, state = pre.fn(params, b)
    if split:   # the unsharded prefill's state in the split-K layout
        assert dec.meta["split_k"]
        state = sh._map_specs(
            lambda t, s: t if t.ndim == 0 else sh.distribute_tree(t, s, mesh),
            state, dec.meta["sspecs"])
    logits = lm.whole_vocab(logits)
    tok = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
    toks = [_host(tok)]
    if mesh is not None:
        tok = sh.distribute_tree(tok, (sh._n(dec.meta["dp"]), None), mesh)
    p = params if mesh is None else dparams
    for _ in range(steps):
        tok, state = dec.fn(p, tok, state)
        toks.append(_host(tok))
    return (_host(logits), np.concatenate(toks, axis=1),
            [x for x in _host(tree_leaves(list(state))) if x is not None])


def _restore(tmp):
    """A tree saved from (2, 2) restored onto (4, 1) and onto no mesh."""
    import weakref

    from repro_torch.checkpoint import CheckpointStore

    m22, m41 = _mesh((2, 2)), _mesh((4, 1))
    full = {"w": torch.arange(96.0).reshape(8, 12),
            "b": torch.arange(16, dtype=torch.bfloat16),
            "n": [torch.tensor(3, dtype=torch.int32)]}
    specs = {"w": ("data", "model"), "b": ("model",), "n": [()]}
    store = CheckpointStore(Path(tmp) / "ck")
    # every whole leaf the save gathers, and how many of the earlier ones
    # are still alive at each gather
    gathered, alive, whole = [], [], sh.whole

    def watch(x):
        alive.append(sum(r() is not None for r in gathered))
        out = whole(x)
        if out is not x:
            gathered.append(weakref.ref(out))
        return out
    sh.whole = watch
    try:
        store.save(5, sh.distribute_tree(full, specs, m22))
    finally:
        sh.whole = whole
    meta = {k: torch.empty_like(v, device="meta") for k, v in
            (("w", full["w"]), ("b", full["b"]))}
    onto = {"w": sh.distribute_tree(meta["w"], (None, "data"), m41),
            "b": sh.distribute_tree(full["b"], ("data",), m41),
            "n": [None]}
    got, step, _ = store.restore(full, shardings=onto)
    plain, _, _ = store.restore(full)
    return dict(step=step, gathered=len(gathered), alive=alive,
                placements=[str(got["w"].placements),
                                       str(got["b"].placements)],
                local_w=got["w"].to_local().numpy(),
                whole=_host(got), plain=_host(plain),
                plain_types=[type(v).__name__ for v in
                             (plain["w"], plain["b"], plain["n"][0])])


def _launcher(tmp):
    """The train launcher on (2, 2) with the drill, then resumed on (4, 1):
    each run's summary."""
    from repro_torch.launch import train as ptrain

    ck = str(Path(tmp) / "launch")
    argv = ["--device", "cpu", "--steps", "6", "--batch", "4", "--seq",
            "16", "--ckpt-every", "2", "--ckpt-dir", ck, "--log-every", "1"]
    first = ptrain.main(argv + ["--data", "2", "--model-axis", "2",
                                "--inject-failure", "3"])
    dist.barrier()
    argv[argv.index("6")] = "8"
    second = ptrain.main(argv + ["--data", "4"])
    keep = ("steps", "start", "resumed_at", "losses")
    return {k: first[k] for k in keep}, {k: second[k] for k in keep}


def _work(rank, world, inputs, tmp):
    torch.set_num_threads(1)
    out = {"train": {}, "serve": {}}
    for name, shape in TRAIN_CASES:
        cfg, tree, batch = inputs["train"][name]
        out["train"][name, shape] = _train(cfg, tree, batch, _mesh(shape))
    for name, shape in SERVE_CASES:
        cfg, tree, prompt = inputs["serve"][name]
        out["serve"][name, shape] = _serve(cfg, tree, prompt, _mesh(shape))
    cfg, tree, batch, prompt = inputs["moe"]
    out["ep"] = (_train(cfg, tree, batch, _mesh((1, 4)), ep=True),
                 _serve(cfg, tree, prompt, _mesh((1, 4)), ep=True))
    cfg, tree, prompt = inputs["split"]
    out["split"] = _serve(cfg, tree, prompt, _mesh((4, 1)),
                          max_seq=SPLIT_MAX, steps=SPLIT_STEPS, split=True)
    cfg, tree, batch, prompt = inputs["padded"]
    from repro_torch.configs.base import InputShape
    from repro_torch.distribution.steps import make_step_for_cell

    m22 = _mesh((2, 2))
    bundle = make_step_for_cell(cfg, InputShape("p", S, B, "prefill"),
                                mesh=m22, device="cpu")
    cfg_pad = sh.pad_config_for_mesh(cfg, 2)
    params = lm.load_reference_params(tree, cfg_pad, device="cpu")
    logits, _ = bundle.fn(sh.distribute_tree(params, bundle.meta["pspecs"],
                                             m22),
                          sh.distribute_tree(_t(prompt), bundle.meta["bspecs"],
                                             m22))
    out["padded"] = (_host(lm.whole_vocab(logits)),
                     _train(cfg_pad, tree, batch, m22))
    out["restore"] = _restore(tmp)
    out["launcher"] = _launcher(tmp)
    return out if rank == 0 else {}


def _rank_main(rank, world, store, inputs, tmp, q):
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        q.put((rank, _work(rank, world, inputs, tmp)))
    except BaseException:
        import traceback

        q.put((rank, {"error": traceback.format_exc()}))
        raise
    finally:
        dist.destroy_process_group()


def _spawn(inputs, tmp_path) -> dict:
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    store = tmp_path / "store"
    procs = [ctx.Process(target=_rank_main,
                         args=(r, WORLD, str(store), inputs, str(tmp_path), q))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    out = {}
    deadline = time.monotonic() + JOIN_S
    try:
        while len(out) < WORLD and time.monotonic() < deadline:
            try:
                rank, res = q.get(timeout=1.0)
                out[rank] = res
            except queue.Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
    finally:
        for p in procs:
            p.join(10 if len(out) == WORLD else 0)
            if p.is_alive():
                p.kill()
    errors = [r.get("error") for r in out.values() if "error" in r]
    assert not errors, errors[0]
    assert [p.exitcode for p in procs] == [0] * WORLD
    return out[0]


def _inputs() -> dict:
    inputs = {"train": {}, "serve": {}}
    for name, _ in TRAIN_CASES:
        cfg_r, cfg_p = _cfgs(name)
        inputs["train"][name] = (cfg_p, _ref_tree(cfg_r), _batch(cfg_r, B, S,
                                                                 seed=1))
    for name, _ in SERVE_CASES:
        cfg_r, cfg_p = _cfgs(name)
        inputs["serve"][name] = (cfg_p, _ref_tree(cfg_r),
                                 _prompt(cfg_r, B, S, seed=2))
    cfg_r, cfg_p = _cfgs("qwen2_moe_a2p7b")
    inputs["moe"] = (cfg_p, _ref_tree(cfg_r), _batch(cfg_r, B, S, seed=1),
                     _prompt(cfg_r, B, S, seed=2))
    cfg_r, cfg_p = _cfgs("qwen2_7b")
    inputs["split"] = (cfg_p, _ref_tree(cfg_r),
                       _prompt(cfg_r, 1, SPLIT_P, seed=3))
    cfg_r, cfg_p = _cfgs("smollm_135m", **PADDED)
    pad_r = ref_sh.pad_config_for_mesh(cfg_r, 2)
    inputs["padded"] = (cfg_p, _ref_tree(pad_r), _batch(cfg_r, B, S, seed=1),
                        _prompt(cfg_r, B, S, seed=2))
    return inputs


@pytest.fixture(scope="module")
def ran(tmp_path_factory):
    """The ranks' results and the inputs they ran on."""
    tmp = tmp_path_factory.mktemp("lm_mesh")
    inputs = _inputs()
    return _spawn(inputs, tmp), inputs


# ---------------------------------------------------- the port, unsharded
def _unsharded_train(cfg, tree, batch):
    return _train(cfg, tree, batch, None)


def _leaf_err(g, w):
    return float(np.abs(g - w).max()) / (1.0 + float(np.abs(w).max()))


def _same_train(got, want, label):
    (lg, gg), (lw, gw) = got, want
    assert abs(lg - lw) <= LOSS_RTOL * abs(lw), (label, lg, lw)
    assert len(gg) == len(gw), label
    for i, (a, b) in enumerate(zip(gg, gw)):
        assert _leaf_err(a, b) < GRAD_TOL, (label, i, _leaf_err(a, b))


def _same_serve(got, want, label):
    (lg, tg, sg), (lw, tw, sw) = got, want
    np.testing.assert_allclose(lg, lw, err_msg=label, **TOL)
    assert np.array_equal(tg, tw), (label, tg, tw)
    assert len(sg) == len(sw), label
    for i, (a, b) in enumerate(zip(sg, sw)):
        np.testing.assert_allclose(a, b, err_msg=f"{label} state {i}", **TOL)


@pytest.mark.parametrize("name,shape", TRAIN_CASES)
def test_train_step_on_a_mesh_matches_the_unsharded_step(ran, name, shape):
    res, inputs = ran
    cfg, tree, batch = inputs["train"][name]
    _same_train(res["train"][name, shape], _unsharded_train(cfg, tree, batch),
                f"{name} {shape}")


@pytest.mark.parametrize("name,shape", SERVE_CASES)
def test_prefill_and_decode_on_a_mesh_match_the_unsharded_steps(ran, name,
                                                                shape):
    res, inputs = ran
    cfg, tree, prompt = inputs["serve"][name]
    _same_serve(res["serve"][name, shape], _serve(cfg, tree, prompt, None),
                f"{name} {shape}")


def _ref_train(cfg_r, tree, batch):
    """The reference's composition of an accum-2 step's loss and gradient:
    ``value_and_grad`` of ``forward_train`` on each half, averaged."""
    fn = jax.jit(jax.value_and_grad(
        lambda p, bb: rlm.forward_train(p, cfg_r, bb), has_aux=True))
    losses, grads = [], []
    for half in (slice(0, B // 2), slice(B // 2, B)):
        (loss, _), g = fn(jax.tree.map(jnp.asarray, tree),
                          {k: v[half] for k, v in batch.items()})
        losses.append(float(loss))
        grads.append(g)
    g = jax.tree.map(lambda a, b: (np.asarray(a, np.float32)
                                   + np.asarray(b, np.float32)) / 2, *grads)
    return float(np.mean(losses)), g


@pytest.mark.parametrize("name", REF_TRAIN)
def test_train_step_on_a_mesh_matches_the_reference_composition(ran, name):
    res, inputs = ran
    cfg_r, cfg_p = _cfgs(name)
    _, tree, batch = inputs["train"][name]
    loss, g = _ref_train(cfg_r, tree, batch)
    want = _leaves_like(g, cfg_p)
    shape = dict(TRAIN_CASES)[name]
    _same_train(res["train"][name, shape], (loss, want), f"{name} reference")


def _leaves_like(tree, cfg_p):
    """A reference tree's leaves in the port's tree order."""
    from repro_torch.utils import tree_leaves

    return [t.numpy() for t in tree_leaves(lm.load_reference_params(
        jax.tree.map(lambda a: np.asarray(a, np.float32), tree), cfg_p,
        device="cpu"))]


@pytest.mark.parametrize("name,shape", REF_SERVE)
def test_prefill_and_decode_on_a_mesh_match_the_reference(ran, name, shape):
    res, inputs = ran
    cfg_r, _ = _cfgs(name)
    _, tree, prompt = inputs["serve"][name]
    max_seq = S + 64
    pj = jax.tree.map(jnp.asarray, tree)
    lj, sj = jax.jit(lambda p, b: rlm.forward_prefill(p, cfg_r, b,
                                                      max_seq=max_seq))(
        pj, {k: jnp.asarray(v) for k, v in prompt.items()})
    step = jax.jit(lambda p, t, s: rlm.forward_decode(p, cfg_r, t, s))
    tok = jnp.argmax(lj[:, -1, :], axis=-1).astype(jnp.int32)[:, None]
    toks = [np.asarray(tok)]
    for _ in range(STEPS):
        logits, sj = step(pj, tok, sj)
        tok = jnp.argmax(logits[:, -1, :], axis=-1).astype(jnp.int32)[:, None]
        toks.append(np.asarray(tok))
    lg, tg, _ = res["serve"][name, shape]
    np.testing.assert_allclose(lg, np.asarray(lj, np.float32), **TOL)
    assert np.array_equal(tg, np.concatenate(toks, axis=1))


def test_expert_parallel_moe_matches_the_unsharded_steps(ran):
    res, inputs = ran
    cfg, tree, batch, prompt = inputs["moe"]
    (train, serve) = res["ep"]
    _same_train(train, _unsharded_train(cfg, tree, batch), "ep train")
    _same_serve(serve, _serve(cfg, tree, prompt, None), "ep serve")


def test_split_k_decode_matches_the_unsharded_decode(ran):
    """Batch 1 on (4, 1): the KV positions in 4 blocks of 8; the prompt of
    7 and 10 steps write positions 7 .. 16, on both sides of the block
    boundaries at 8 and 16."""
    res, inputs = ran
    cfg, tree, prompt = inputs["split"]
    want = _serve(cfg, tree, prompt, None, max_seq=SPLIT_MAX,
                  steps=SPLIT_STEPS)
    _same_serve(res["split"], want, "split-K")
    pos = SPLIT_P + SPLIT_STEPS
    assert pos > 16 and SPLIT_P < 8


def test_a_padded_config_matches_the_reference_padded_config(ran):
    """smollm's 9 / 3 heads at TP 2: ``make_step_for_cell`` pads to 12 / 4
    (``pad_config_for_mesh``), held against the reference's padded config
    run unsharded."""
    res, inputs = ran
    cfg_p, tree, batch, prompt = inputs["padded"]
    cfg_r, _ = _cfgs("smollm_135m", **PADDED)
    pad_r = ref_sh.pad_config_for_mesh(cfg_r, 2)
    assert (pad_r.num_heads, pad_r.num_kv_heads) == (12, 4)
    lj, _ = rlm.forward_prefill(jax.tree.map(jnp.asarray, tree), pad_r,
                                {k: jnp.asarray(v) for k, v in prompt.items()},
                                max_seq=S + 64)
    logits, train = res["padded"]
    np.testing.assert_allclose(logits, np.asarray(lj, np.float32), **TOL)
    loss, _ = _ref_train(pad_r, tree, batch)
    assert abs(train[0] - loss) <= LOSS_RTOL * abs(loss)


def test_restore_with_shardings_reshards_bitwise(ran):
    res, _ = ran
    r = res["restore"]
    assert r["step"] == 5
    whole = {"w": np.arange(96.0).reshape(8, 12),
             "b": np.arange(16, dtype=np.float32), "n": [np.int32(3)]}
    for got in (r["whole"], r["plain"]):
        assert np.array_equal(got["w"], whole["w"])
        assert np.array_equal(got["b"], whole["b"])
        assert int(got["n"][0]) == 3
    assert r["placements"] == ["(Shard(dim=1), Replicate())",
                               "(Shard(dim=0), Replicate())"]
    assert np.array_equal(r["local_w"], whole["w"][:, :3])   # rank 0's block
    assert r["plain_types"] == ["Tensor"] * 3


def test_save_gathers_one_whole_leaf_at_a_time(ran):
    """A mesh checkpoint's save gathers each DTensor leaf whole and drops
    it before gathering the next, so that a device holds at most one
    whole leaf beside its shards (on the card the host copy is a copy;
    here the gathered tensor object must be gone)."""
    res, _ = ran
    r = res["restore"]
    assert r["gathered"] == 3          # "w", "b" and the replicated "n"
    assert r["alive"] == [0, 0, 0]


def test_the_train_launcher_runs_on_a_mesh_and_resumes_onto_another(ran):
    from repro_torch.launch import train as ptrain

    res, _ = ran
    first, second = res["launcher"]
    assert first["resumed_at"] == [2] and first["steps"] == 6
    assert second["start"] == 6 and second["steps"] == 8
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        one = ptrain.main(["--device", "cpu", "--steps", "8", "--batch", "4",
                           "--seq", "16", "--ckpt-every", "2", "--ckpt-dir",
                           tmp, "--log-every", "100"])
    losses = first["losses"][:2] + first["losses"][-4:] + second["losses"]
    assert len(losses) == len(one["losses"]) == 8
    for a, b in zip(losses, one["losses"]):
        assert abs(a - b) <= LOSS_RTOL * abs(b), (losses, one["losses"])


# ------------------------------------------------ placements, shard hook
_INDEX_MAPS = """
import json, sys
import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding
from repro import configs
from repro.distribution import sharding as rs
from repro.models import lm
out = {}
for shape in ((2, 2), (2, 4)):
    n = shape[0] * shape[1]
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape), ("data", "model"))
    ms = rs.MeshSpec.for_mesh(mesh)
    for arch in configs.ARCH_IDS:
        cfg = configs.get(arch, reduced=True)
        tree = jax.eval_shape(lambda: lm.init_params(cfg, jax.random.PRNGKey(0),
                                                    max_seq=64))
        specs = rs.param_pspecs(cfg, tree, ms)
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        sflat = jax.tree_util.tree_leaves(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        for (path, leaf), spec in zip(flat, sflat):
            m = NamedSharding(mesh, spec).devices_indices_map(leaf.shape)
            key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                           for k in path)
            out[f"{shape[0]}x{shape[1]}|{arch}|{key}"] = [
                [[s.start or 0, s.stop if s.stop is not None else d]
                 for s, d in zip(m[dev], leaf.shape)]
                for dev in jax.devices()[:n]]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_index_maps():
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=str(REPO / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", _INDEX_MAPS], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _port_blocks(shape, arch):
    """Each rank's block of every parameter of a reduced config, from the
    placements of its spec and DTensor's own split of a dim over a mesh
    axis (``Shard.local_shard_size_and_offset``, mesh axes in order): key
    -> [per rank, row-major: [[start, stop] a dim]]."""
    from torch.distributed.tensor import Shard

    desc = Mesh(shape, ("data", "model"))
    cfg = configs.get(arch, reduced=True)
    tree = lm.init_params(cfg, None, 64, device="meta")
    specs = sh.param_pspecs(cfg, tree, sh.MeshSpec.for_mesh(desc))
    out = {}

    def walk(t, s, path):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], s[k], path + (k,))
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, s[i], path + (str(i),))
        else:
            pl = sh.placements_for(s, desc)
            blocks = []
            for coord in itertools.product(*(range(n) for n in shape)):
                start, size = [0] * t.ndim, list(t.shape)
                for i, p in enumerate(pl):
                    if p.is_shard():
                        n, off = Shard.local_shard_size_and_offset(
                            size[p.dim], shape[i], coord[i])
                        start[p.dim] += off
                        size[p.dim] = n
                blocks.append([[o, o + n] for o, n in zip(start, size)])
            out["/".join(path)] = blocks
    walk(tree, specs, ())
    return out


@pytest.mark.parametrize("shape", [(2, 2), (2, 4)])
def test_placements_give_the_reference_index_maps(ref_index_maps, shape):
    tag = f"{shape[0]}x{shape[1]}"
    n = 0
    for arch in configs.ARCH_IDS:
        got = _port_blocks(shape, arch)
        want = {k.split("|", 2)[2]: v for k, v in ref_index_maps.items()
                if k.startswith(f"{tag}|{arch}|")}
        assert sorted(got) == sorted(want), arch
        for key in want:
            assert got[key] == want[key], (tag, arch, key)
            n += 1
    assert n > 300


def test_make_shard_fn_drops_axes_that_do_not_divide():
    fn = sh.make_shard_fn(Mesh((2, 4), ("data", "model")),
                          sh.MeshSpec(), ("data",))
    d = ("data",)   # the reference's P(dp, ...) with dp a tuple of axes
    assert fn.spec("act_btd", (4, 8, 16)) == (d, None, None)
    assert fn.spec("act_btd", (3, 8, 16)) == (None, None, None)
    assert fn.spec("act_heads", (4, 8, 6, 32)) == (d, None, None, None)
    assert fn.spec("act_heads", (4, 8, 8, 32)) == (d, None, "model", None)
    assert fn.spec("logits", (2, 1, 510)) == (d, None, None)
    assert fn.spec("act_moe_ff", (4, 6, 64)) == (None, d, "model")
    assert fn.spec("unknown", (4, 4)) is None
    multi = sh.make_shard_fn(Mesh((2, 4, 2), ("pod", "data", "model")),
                             sh.MeshSpec(data=("pod", "data")),
                             ("pod", "data"))
    assert multi.spec("act_ff", (8, 3, 4)) == (("pod", "data"), None, "model")
    assert multi.spec("act_ff", (4, 3, 4)) == (None, None, "model")
    plain = torch.ones(3, 4)
    assert fn("act_ff", plain) is plain   # plain tensors pass through
    with pytest.raises(ValueError, match="axis order"):
        sh.placements_for((("data", "pod"),), Mesh((2, 2), ("pod", "data")))


def test_block_index_and_the_dropping_rules_on_placements():
    """``block_index`` counts the first-named mesh dim major, and
    ``even_placements`` / ``drop_nondividing`` drop the axes that do not
    divide a dim (on a stand-in for a ``DeviceMesh``'s sizes and ranks)."""
    from torch.distributed.tensor import Replicate, Shard

    class _Mesh:
        sizes, ranks = (2, 4), (1, 3)

        def size(self, i):
            return self.sizes[i]

        def get_local_rank(self, i):
            return self.ranks[i]

    m = _Mesh()
    assert sh.block_index(m, [0, 1]) == 7 and sh.block_index(m, [1]) == 3
    assert sh.block_index(m, []) == 0
    assert sh.even_placements([Shard(0), Shard(1)], (4, 6), m) == \
        [Shard(0), Replicate()]
    assert sh.even_placements([Replicate(), Shard(1)], (3, 8), m) == \
        [Replicate(), Shard(1)]
    desc = Mesh((2, 4), ("data", "model"))
    assert sh.drop_nondividing(("data", "model"), (4, 6), desc) == \
        ("data", None)
    assert sh.drop_nondividing((("data", "model"), None), (16, 3), desc) == \
        (("data", "model"), None)
    assert sh.drop_nondividing((("data", "model"), None), (4, 3), desc) == \
        (None, None)
