"""``repro_torch.core.policy`` and ``repro_torch.optim.rmsprop`` against the
reference's JAX policy, with the weights carried across by
``ReinforceAgent.load_reference_params``.

Contracts: logits and one whole ``_update_step`` (params, rmsprop ``nu``,
loss, first-step return) f32-allclose (rtol 1e-5: the same f32 matmuls and
softmax, summed in another order); greedy actions and — with the
reference's Gumbel draws injected — sampled actions exact;
``discounted_returns_device`` exact (the same reverse recurrence); sampling
frequencies of the port's own draws statistical, at the
``tests/chaos_harness.py`` tolerances.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from chaos_harness import DEFAULT_TOL, rel  # noqa: E402
from test_torch_window import JaxStep  # noqa: E402

from repro.core import policy as ref_pol  # noqa: E402
from repro_torch.core import policy as pol  # noqa: E402
from repro_torch.engine.draws import PhiloxDraws  # noqa: E402

D, LEVERS = 65, ["a", "b", "c", "d", "e"]
RTOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _agents(seed=0):
    ref = ref_pol.ReinforceAgent(D, LEVERS, seed=seed)
    port = pol.ReinforceAgent(D, LEVERS, seed=seed, device="cpu")
    port.load_reference_params({k: np.asarray(v)
                                for k, v in ref.params.items()})
    return ref, port


def _states(n, seed=0):
    return np.random.default_rng(seed).random((n, D)).astype(np.float32)


def test_policy_module_shape():
    _, port = _agents()
    assert port.policy.l1.in_features == D
    assert port.policy.l1.out_features == 20
    assert port.policy.l2.out_features == 2 * len(LEVERS)


def test_logits_match_reference():
    ref, port = _agents()
    s = _states(64)
    r = np.asarray(jax.vmap(lambda x: ref_pol.policy_logits(ref.params, x))(
        jnp.asarray(s)))
    with torch.no_grad():
        got = pol.policy_logits(port.policy, torch.from_numpy(s)).numpy()
    np.testing.assert_allclose(got, r, rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("exploit", [False, True])
def test_actions_match_reference_on_its_draws(exploit):
    ref, port = _agents(seed=3)
    s = _states(256, seed=1)
    key = jax.random.PRNGKey(11)
    k_act = jax.random.split(key, 3)[0]
    greedy_ref = ref_pol._sample_actions(ref.params, jnp.asarray(s), k_act,
                                         jnp.float32(0.8), exploit,
                                         greedy=True)
    greedy = pol._sample_actions(port.policy, torch.from_numpy(s), None, 0.8,
                                 exploit, greedy=True)
    np.testing.assert_array_equal(greedy.numpy(), np.asarray(greedy_ref))
    sampled_ref = ref_pol._sample_actions(ref.params, jnp.asarray(s), k_act,
                                          jnp.float32(0.8), exploit)
    sampled = pol._sample_actions(port.policy, torch.from_numpy(s),
                                  JaxStep(key), 0.8, exploit)
    np.testing.assert_array_equal(sampled.numpy(), np.asarray(sampled_ref))


def test_sampling_frequencies_follow_the_f_gated_mixture():
    """The port's own Philox draws: over 40k rows of one state the action
    frequencies match the f-gated mixture (1-f)·softmax + f·[top lever's
    renormalised pair], and the reference's threefry draws agree with it."""
    ref, port = _agents(seed=5)
    n, f = 40_000, 0.8
    s = np.repeat(_states(1, seed=2), n, axis=0)
    with torch.no_grad():
        p = torch.softmax(port.policy(torch.from_numpy(s[:1])), -1)[0].numpy()
    expect = (1 - f) * p
    expect[:2] += f * p[:2] / p[:2].sum()
    got = pol._sample_actions(port.policy, torch.from_numpy(s),
                              PhiloxDraws(0, "cpu"), f, True).numpy()
    r = np.asarray(ref_pol._sample_actions(ref.params, jnp.asarray(s),
                                           jax.random.PRNGKey(0),
                                           jnp.float32(f), True))
    for a in np.nonzero(expect > 0.02)[0]:
        for freq in ((got == a).mean(), (r == a).mean()):
            assert rel(freq, expect[a]) < DEFAULT_TOL.median_reward, (
                a, freq, expect[a])


def test_discounted_returns_exact():
    """Exact at the paper's gamma = 1 (plain f32 adds in the same reverse
    order); at gamma < 1 XLA fuses ``r + gamma·acc`` into one multiply-add,
    a last-bit difference."""
    rw = np.random.default_rng(0).normal(size=(9, 7)).astype(np.float32)
    for gamma in (1.0, 0.9):
        r = np.asarray(ref_pol.discounted_returns_device(jnp.asarray(rw),
                                                         gamma))
        got = pol.discounted_returns_device(torch.from_numpy(rw), gamma)
        if gamma == 1.0:
            np.testing.assert_array_equal(got.numpy(), r)
        else:
            np.testing.assert_allclose(got.numpy(), r, rtol=1e-6, atol=1e-6)


def test_update_step_matches_reference():
    ref, port = _agents(seed=1)
    N, S = 16, 5
    rng = np.random.default_rng(4)
    states = rng.random((N, S, D)).astype(np.float32)
    actions = rng.integers(0, 10, (N, S)).astype(np.int32)
    rewards = (-rng.random((N, S)) * 3).astype(np.float32)
    mask = np.ones((N, S), np.float32)
    mask[:3, 3:] = 0.0                       # ragged episodes
    for _ in range(2):                       # second step exercises nu
        r_params, r_opt, r_loss, r_first = ref._update_jit(
            ref.params, ref.opt_state, jnp.asarray(states),
            jnp.asarray(actions), jnp.asarray(rewards), jnp.asarray(mask))
        ref.params, ref.opt_state = r_params, r_opt
        stats = port.update_batch(states, actions, rewards, mask)
        assert stats["pg_loss"] == pytest.approx(float(r_loss), rel=1e-4)
        assert stats["mean_return"] == pytest.approx(float(r_first), rel=RTOL)
        assert stats["steps"] == int(mask.sum())
        own = port.params
        for rname, (name, transpose) in pol._REF_NAMES.items():
            got = own[name].detach().numpy()
            got_nu = port.opt_state["nu"][name].numpy()
            if transpose:
                got, got_nu = got.T, got_nu.T
            np.testing.assert_allclose(got, np.asarray(r_params[rname]),
                                       rtol=RTOL, atol=1e-6, err_msg=rname)
            np.testing.assert_allclose(got_nu, np.asarray(r_opt["nu"][rname]),
                                       rtol=1e-4, atol=1e-12, err_msg=rname)
    assert int(port.opt_state["count"]) == int(ref.opt_state["count"]) == 2
    assert port.n_updates == 2


def test_rmsprop_eps_outside_the_sqrt():
    from repro_torch.optim import rmsprop

    opt = rmsprop(lr=0.1, decay=0.5, eps=1.0)
    p = {"w": torch.tensor([1.0])}
    new, st = opt.update({"w": torch.tensor([2.0])}, opt.init(p), p)
    # nu = 0.5·4 = 2; step = 0.1·2 / (sqrt(2) + 1)
    assert new["w"].item() == pytest.approx(1.0 - 0.2 / (np.sqrt(2.0) + 1.0))
    assert st["nu"]["w"].item() == pytest.approx(2.0)


def test_load_reference_opt_state():
    ref, port = _agents(seed=2)
    opt = {"nu": {k: np.full(np.shape(v), 0.5, np.float32)
                  for k, v in ref.params.items()}, "count": 7}
    port.load_reference_params({k: np.asarray(v)
                                for k, v in ref.params.items()}, opt)
    assert int(port.opt_state["count"]) == 7
    assert port.opt_state["nu"]["l1.weight"].shape == (20, D)
