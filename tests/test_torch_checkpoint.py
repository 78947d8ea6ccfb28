"""The port's checkpoint store (``repro_torch.checkpoint.CheckpointStore``)
on the CPU.

* The cases of tests/test_checkpoint.py on the port's store: round trip,
  async save, GC of old steps and of torn writes, latest / specific step,
  the missing-checkpoint error, the manifest's schema, and a policy's
  parameters and rmsprop state round-tripping mid-training (here on torch
  tensors). The reference's reshard case: the port's ``shardings=``
  keeps None leaves whole here (meshes in tests/test_torch_lm_mesh.py).
* Against the reference's store: the same tree saved by both stores gives
  the same files byte for byte, and a checkpoint written by either one
  reads back bitwise through the other — f64, int64 and uint64 leaves
  included (the reference's side reads with ``host=True``, its exact path).
"""
import json

import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointStore as RefStore
from repro_torch.checkpoint import CheckpointStore
from repro_torch.core.policy import ReinforceAgent


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": torch.as_tensor(rng.normal(0, 1, (8, 4)),
                                        dtype=torch.float32),
                   "layers": [torch.ones((3,)), torch.zeros((2, 2))]},
        "opt": {"mu": {"w": torch.full((8, 4), 0.5)},
                "count": torch.tensor(7)},
    }


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _wide_tree(seed=0):
    """Leaves of every width the serve controller saves: f64 clocks, int64
    counts, uint64 RNG words, uint8 generator states, f32 and int32."""
    rng = np.random.default_rng(seed)
    return {"clock": rng.uniform(0, 1e6, 5) + 0.1234567890123456,
            "hits": rng.integers(0, 2**62, 4, dtype=np.int64),
            "words": rng.integers(0, 2**63, (3, 4), dtype=np.uint64) * 2 + 1,
            "gen": np.frombuffer(rng.bytes(16), np.uint8).copy(),
            "w": rng.normal(size=(6, 2)).astype(np.float32),
            "count": np.asarray(3, np.int32),
            "nested": [np.float64(np.pi), np.arange(3, dtype=np.int64)]}


def test_save_restore_roundtrip(tmp_path):
    store = CheckpointStore(tmp_path)
    t = _tree()
    store.save(10, t, extra={"note": "hello"})
    restored, step, extra = store.restore(t)
    assert step == 10 and extra == {"note": "hello"}
    for a, b in zip(_leaves(t), _leaves(restored)):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype
        assert torch.equal(a, b)


def test_async_save_then_wait(tmp_path):
    store = CheckpointStore(tmp_path)
    store.save_async(1, _tree(1))
    store.wait()
    assert store.latest_step() == 1


def test_gc_keeps_last_k(tmp_path):
    store = CheckpointStore(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        store.save(s, _tree(s))
    assert store.all_steps() == [3, 4]


def test_torn_tmp_dirs_are_garbage_collected(tmp_path):
    store = CheckpointStore(tmp_path)
    torn = tmp_path / ".tmp-99"
    torn.mkdir()
    (torn / "leaf_00000.npy").write_bytes(b"garbage")
    store.save(5, _tree())
    assert not torn.exists()
    assert store.latest_step() == 5


def test_restore_latest_and_specific(tmp_path):
    store = CheckpointStore(tmp_path)
    store.save(1, {"x": torch.tensor(1.0)})
    store.save(2, {"x": torch.tensor(2.0)})
    t, step, _ = store.restore({"x": torch.tensor(0.0)})
    assert step == 2 and float(t["x"]) == 2.0
    t, step, _ = store.restore({"x": torch.tensor(0.0)}, step=1)
    assert step == 1 and float(t["x"]) == 1.0


def test_restore_with_shardings_waits_for_the_mesh(tmp_path):
    """The reference's elastic reshard-on-restore: ``shardings=`` places
    leaves on an LM mesh (tests/test_torch_lm_mesh.py restores a (2, 2)
    checkpoint onto (4, 1)); a None leaf keeps the leaf whole, and numpy
    leaves (``host=True``) cannot be placed."""
    store = CheckpointStore(tmp_path)
    t = {"w": torch.arange(16.0).reshape(4, 4)}
    store.save(3, t)
    placed, step, _ = store.restore(t, shardings={"w": None})
    assert step == 3 and type(placed["w"]) is torch.Tensor
    assert torch.equal(placed["w"], t["w"])
    with pytest.raises(ValueError, match="host=True"):
        store.restore(t, shardings={"w": None}, host=True)
    restored, step, _ = store.restore(t)
    assert step == 3 and torch.equal(restored["w"], t["w"])


def test_missing_checkpoint_raises(tmp_path):
    store = CheckpointStore(tmp_path)
    with pytest.raises(FileNotFoundError):
        store.restore({"x": torch.tensor(0.0)})


def test_manifest_is_valid_json_with_leaf_metadata(tmp_path):
    store = CheckpointStore(tmp_path)
    store.save(4, _tree())
    man = json.loads((tmp_path / "step_00000004" / "manifest.json").read_text())
    assert man["step"] == 4
    leaf = next(iter(man["leaves"].values()))
    assert set(leaf) == {"file", "shape", "dtype"}


def test_default_restore_puts_tensors_on_the_store_device(tmp_path):
    store = CheckpointStore(tmp_path, device="cpu")
    store.save(0, _wide_tree())
    got, _, _ = store.restore(_wide_tree())
    for a, b in zip(_leaves(_wide_tree()), _leaves(got)):
        assert isinstance(b, torch.Tensor) and b.device == store.device
        assert b.numpy().dtype == np.asarray(a).dtype
        assert np.array_equal(b.numpy(), np.asarray(a))


def test_policy_and_optimizer_midtraining_roundtrip(tmp_path):
    """Resume-from-checkpoint for the RL loop: a mid-training agent's
    parameters and rmsprop state, saved as torch tensors and restored into
    a FRESH differently-seeded agent's buffers, give the same greedy
    actions and the same next update, bit for bit."""
    rng = np.random.default_rng(0)
    D, levers = 12, ["a", "b", "c"]
    states = rng.normal(0, 1, (5, 4, D)).astype(np.float32)   # (N, S, D)
    actions = rng.integers(0, 2 * len(levers), (5, 4))
    rewards = rng.normal(-5, 1, (5, 4)).astype(np.float32)

    agent = ReinforceAgent(D, levers, seed=0, device="cpu")
    for _ in range(2):                              # mid-training
        agent.update_batch(states, actions, rewards)
    store = CheckpointStore(tmp_path)
    store.save(agent.n_updates,
               {"params": agent.params, "opt_state": agent.opt_state},
               extra={"n_updates": agent.n_updates})

    fresh = ReinforceAgent(D, levers, seed=123, device="cpu")
    restored, step, extra = store.restore(
        {"params": fresh.params, "opt_state": fresh.opt_state})
    buffers = {k: v.data_ptr() for k, v in fresh.params.items()}
    fresh._write_state(restored["params"], restored["opt_state"])
    fresh.n_updates = extra["n_updates"]
    assert step == 2 and fresh.n_updates == agent.n_updates
    # restored INTO the buffers a captured update reads
    assert {k: v.data_ptr() for k, v in fresh.params.items()} == buffers

    flat = rng.normal(0, 1, (7, D)).astype(np.float32)
    assert np.array_equal(agent.act_batch(flat, greedy=True),
                          fresh.act_batch(flat, greedy=True))
    s1 = agent.update_batch(states, actions, rewards)
    s2 = fresh.update_batch(states, actions, rewards)
    assert s1["pg_loss"] == s2["pg_loss"]
    for k in agent.params:
        assert torch.equal(agent.params[k], fresh.params[k])
        assert torch.equal(agent.opt_state["nu"][k], fresh.opt_state["nu"][k])
    assert torch.equal(agent.opt_state["count"], fresh.opt_state["count"])


# ----------------------------------------------- against the reference store
def test_same_tree_gives_the_same_files(tmp_path):
    """The on-disk layout is the reference's byte for byte: every leaf file
    and the manifest."""
    tree = _wide_tree(1)
    RefStore(tmp_path / "ref").save(7, tree, extra={"cycle": 7})
    CheckpointStore(tmp_path / "port").save(7, tree, extra={"cycle": 7})
    a, b = tmp_path / "ref" / "step_00000007", tmp_path / "port" / "step_00000007"
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir())
    for n in names:
        assert (a / n).read_bytes() == (b / n).read_bytes(), n


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_reads_back_bitwise_through_the_other_store(tmp_path,
                                                               writer):
    tree = _wide_tree(2)
    if writer == "reference":
        RefStore(tmp_path).save(3, tree, extra={"who": writer})
        got, step, extra = CheckpointStore(tmp_path).restore(tree, host=True)
        as_tensors, _, _ = CheckpointStore(tmp_path).restore(tree)
        for a, b in zip(_leaves(tree), _leaves(as_tensors)):
            assert np.array_equal(b.numpy(), np.asarray(a))
            assert b.numpy().dtype == np.asarray(a).dtype
    else:
        # the port writes torch tensors where it has them
        src = dict(tree, w=torch.from_numpy(tree["w"]),
                   hits=torch.from_numpy(tree["hits"]))
        CheckpointStore(tmp_path).save(3, src, extra={"who": writer})
        got, step, extra = RefStore(tmp_path).restore(tree, host=True)
    assert step == 3 and extra == {"who": writer}
    for a, b in zip(_leaves(tree), _leaves(got)):
        a = np.asarray(a)
        assert isinstance(b, np.ndarray) and b.dtype == a.dtype
        assert b.tobytes() == a.tobytes()
