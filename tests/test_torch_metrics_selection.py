"""``repro_torch.core.metrics_selection`` against the reference's
``repro.core.metrics_selection`` on identical numpy inputs.

Contracts: the numpy stages (variance filter, standardisation, the natural
cubic spline and its repair, parallel analysis, FA, factor retention) are
bitwise copies; k-means in torch, fed the reference's k-means++ picks
(``ref_picks`` replays its threefry seeding on the same points): the
assignments equal, centres and cost within 1e-5 (f32 Lloyd sums in another
order); ``sweep_k`` and ``select_metrics`` equal under the same injection.
Points are drawn in general position, so no two distances tie.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import metrics_selection as ref  # noqa: E402
from repro_torch.core import metrics_selection as ms  # noqa: E402

#: Lloyd's centre sums and the cost in f32, summed in another order
KM_TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ref_picks(points: np.ndarray, k: int, key_seed: int) -> np.ndarray:
    """The row indices the reference's ``_kmeans_once`` seeds with under
    ``PRNGKey(key_seed)``: its k-means++ loop, op for op, returning the
    picks instead of the centres."""
    return np.asarray(_ref_picks(jnp.asarray(points, jnp.float32), k,
                                 jax.random.PRNGKey(key_seed)))


@functools.partial(jax.jit, static_argnums=1)
def _ref_picks(pts, k, key):
    n, d = pts.shape

    def seed_body(i, carry):
        centers, key, picks = carry
        d2 = jnp.min(
            jnp.sum((pts[:, None, :] - centers[None, :, :]) ** 2, axis=-1)
            + jnp.where(jnp.arange(centers.shape[0])[None, :] < i, 0.0,
                        jnp.inf),
            axis=1,
        )
        key, sub = jax.random.split(key)
        probs = d2 / jnp.maximum(d2.sum(), 1e-12)
        idx = jax.random.choice(sub, n, p=probs)
        return centers.at[i].set(pts[idx]), key, picks.at[i].set(idx)

    key, sub = jax.random.split(key)
    first = jax.random.randint(sub, (), 0, n)
    centers0 = jnp.zeros((k, d)).at[0].set(pts[first])
    picks0 = jnp.zeros(k, jnp.int32).at[0].set(first)
    _, _, picks = jax.lax.fori_loop(1, k, seed_body, (centers0, key, picks0))
    return picks


def _blobs(n_per=12, centres=4, d=3, seed=0):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.normal(c * 3.0, 0.6, (n_per, d))
                           for c in range(centres)])


def _planted_metrics(n=300, seed=5):
    """tests/test_metrics_selection.py's three latent groups + constants,
    with a few NaN gaps for the spline repair."""
    rng = np.random.default_rng(seed)
    f = rng.normal(0, 1, (n, 3))
    names, cols = [], []
    for j in range(3):
        for i in range(8):
            names.append(f"g{j}_m{i}")
            cols.append(f[:, j] * 0.9 + rng.normal(0, 0.25, n))
    names += ["const1", "const2"]
    cols += [np.full(n, 7.0), np.full(n, 0.001)]
    X = np.stack(cols, axis=1)
    X[rng.integers(0, n, 12), rng.integers(0, 24, 12)] = np.nan
    return X, names


def test_numpy_stages_are_bitwise_copies():
    X, _ = _planted_metrics()
    np.testing.assert_array_equal(ms.variance_filter(X),
                                  ref.variance_filter(X))
    rep = ms.spline_repair(X)
    np.testing.assert_array_equal(rep, ref.spline_repair(X))
    for a, b in zip(ms.standardise(rep), ref.standardise(rep)):
        np.testing.assert_array_equal(a, b)
    xk = np.array([0.0, 1.5, 2.0, 4.0, 7.0])
    yk = np.array([1.0, -1.0, 0.5, 2.0, 0.0])
    xq = np.linspace(-1, 8, 31)
    for m in (1, 2, 5):
        np.testing.assert_array_equal(
            ms._natural_cubic_spline(xk[:m], yk[:m], xq),
            ref._natural_cubic_spline(xk[:m], yk[:m], xq))
    Z, _, _ = ref.standardise(rep[:, :24])
    np.testing.assert_array_equal(
        ms.parallel_analysis(300, 24, np.random.default_rng(1)),
        ref.parallel_analysis(300, 24, np.random.default_rng(1)))
    np.testing.assert_array_equal(ms.factor_analysis(Z, 3),
                                  ref.factor_analysis(Z, 3))
    assert ms.retained_factors(Z, np.random.default_rng(2)) == \
        ref.retained_factors(Z, np.random.default_rng(2))


@pytest.mark.parametrize("k", [2, 4, 6])
def test_kmeans_matches_reference_with_its_picks_injected(k):
    pts = _blobs(seed=k)
    got = ms.kmeans(pts, k, seed=k, device="cpu", init=ref_picks)
    want = ref.kmeans(pts, k, seed=k)
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=KM_TOL,
                               atol=KM_TOL)
    assert got[2] == pytest.approx(want[2], rel=KM_TOL)


def test_kmeans_once_with_a_generator_is_seeded_and_consistent():
    """The port's own draws: the same generator seed gives the same
    clustering, every row is assigned to its nearest centre, and the cost
    is the sum of the squared distances to those centres."""
    pts = torch.as_tensor(_blobs(n_per=10, centres=3, seed=9),
                          dtype=torch.float32)
    runs = [ms._kmeans_once(pts, 3, generator=torch.Generator().manual_seed(7))
            for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    c, assign, cost = runs[0]
    d2 = ms._sq_dists(pts, c)
    assert torch.equal(assign, torch.argmin(d2, dim=1))
    torch.testing.assert_close(cost, d2.min(dim=1).values.sum())
    assert len(set(assign.tolist())) == 3
    # injected picks replace the draws
    c2, a2, _ = ms._kmeans_once(pts, 3, init_idx=[0, 10, 20])
    assert sorted(set(a2.tolist())) == [0, 1, 2]


def test_sweep_k_matches_reference_with_its_picks_injected():
    rng = np.random.default_rng(4)
    pts = np.concatenate([rng.normal(c * 8, 0.3, (12, 2)) for c in range(3)])
    got = ms.sweep_k(pts, [2, 3, 4], seed=0, device="cpu", init=ref_picks)
    assert got == ref.sweep_k(pts, [2, 3, 4], seed=0) == 3


def test_select_metrics_matches_reference_with_its_picks_injected():
    X, names = _planted_metrics()
    kw = dict(seed=0, k_candidates=(2, 3, 4, 5))
    got = ms.select_metrics(X, names, device="cpu", init=ref_picks, **kw)
    want = ref.select_metrics(X, names, **kw)
    assert got.kept_names == want.kept_names
    assert got.cluster_of == want.cluster_of
    assert got.survivor_names == want.survivor_names
    assert (got.n_factors, got.k) == (want.n_factors, want.k)
    assert got.reduction == want.reduction
    np.testing.assert_array_equal(got.loadings, want.loadings)
    # the port's own draws: the same structure is found
    own = ms.select_metrics(X, names, device="cpu", **kw)
    assert "const1" not in own.survivor_names and own.reduction > 0.7
    assert len({n.split("_")[0] for n in own.kept_names}) >= 2


def test_select_metrics_split_runs_batches_separately():
    rng = np.random.default_rng(6)
    X = rng.normal(0, 1, (100, 10))
    names = [f"m{i}" for i in range(10)]
    is_driver = [i < 4 for i in range(10)]
    stage_s = {}
    rd, rw = ms.select_metrics_split(X, names, is_driver, k=2, device="cpu",
                                     stage_s=stage_s)
    assert all(n in names[:4] for n in rd.kept_names)
    assert all(n in names[4:] for n in rw.kept_names)
    assert set(stage_s) == {"fa", "kmeans"}
