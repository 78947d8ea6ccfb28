"""``repro_torch.core.lasso`` and ``repro_torch.kernels.lasso_cd`` against
the reference's ``repro.core.lasso`` on identical numpy inputs; and (on a
card) the CUDA kernel against its plain version.

Contracts: ``normalise_levers`` and ``polynomial_features`` bitwise (numpy
copies); one ``_cd_epoch`` f32-allclose (rtol 1e-5: the same f32 update,
the dot summed in another order); ``lasso_path`` coefficients rtol 1e-4 /
atol 1e-6 (3600 chained epochs of that rounding) and the entry order equal
where the planted gaps are clear; ``rank_levers`` equal on a fixed
109-lever planted matrix. On a CPU tensor the wrapper runs its plain
version. The kernel's CPU mirror (its carried gradient, in numpy f32) is
held within ``LASSO_TOL`` of the plain version and of the reference's path,
with the entry order equal; on the card the kernel is held to the mirror
bitwise from w0 = 0, and within ``LASSO_TOL`` of the plain version.

The ``gpu`` tests need neither jax nor the reference:
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_lasso.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import lasso  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import lasso_cd as lc  # noqa: E402

try:  # the reference; absent where only the port is installed
    import jax.numpy as jnp
    from repro.core import lasso as ref
except ImportError:  # pragma: no cover - a port-only install
    jnp = ref = None

needs_reference = pytest.mark.skipif(ref is None,
                                     reason="needs jax and the reference")
#: one epoch: the same f32 update, the dot summed in another order
EPOCH_RTOL = 1e-5
#: a whole path: 3600 chained epochs of that rounding
PATH_RTOL, PATH_ATOL = 1e-4, 1e-6
#: kernel or mirror vs the plain version or the reference, max |difference|
#: over max(1, max |theirs|): the same f32 updates with the gradient carried
#: instead of a dot taken afresh, over a whole path (chip_smoke.py's)
LASSO_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _planted(n=400, p=30, seed=0):
    """tests/test_lasso.py's planted signal: features 2, 5 and 9."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p))
    y = 3.0 * X[:, 2] - 2.0 * X[:, 5] + 0.7 * X[:, 9] \
        + 0.05 * rng.standard_normal(n)
    return X, y


def _planted_levers(n=1200, levers=109, seed=1):
    """Integer lever settings (the tuner's numbered levers) with four
    effective levers, one of them quadratic."""
    rng = np.random.default_rng(seed)
    R = rng.integers(0, 10, (n, levers)).astype(float)
    y = 0.8 * R[:, 3] - 0.5 * R[:, 17] + 0.03 * R[:, 40] ** 2 \
        + 0.2 * R[:, 60] + 0.5 * rng.standard_normal(n)
    return R, y, [f"L{i}" for i in range(levers)]


@needs_reference
@pytest.mark.parametrize("interactions", [False, True])
def test_normalise_and_polynomial_features_are_bitwise_copies(interactions):
    rng = np.random.default_rng(3)
    R = np.column_stack([rng.integers(0, 5, 50).astype(float), np.ones(50),
                         rng.standard_normal(50), rng.uniform(0, 9, 50)])
    for a, b in zip(lasso.normalise_levers(R), ref.normalise_levers(R)):
        np.testing.assert_array_equal(a, b)
    Z, _, _ = ref.normalise_levers(R)
    names = ["a", "b", "c", "d"]
    Xp, n_p = lasso.polynomial_features(Z, names, interactions=interactions)
    Xr, n_r = ref.polynomial_features(Z, names, interactions=interactions)
    np.testing.assert_array_equal(Xp, Xr)
    assert n_p == n_r


@needs_reference
def test_one_epoch_matches_reference():
    X, y = _planted(n=200, p=24, seed=4)
    yc = y - y.mean()
    XtX = (X.T @ X).astype(np.float32)
    Xty = (X.T @ yc).astype(np.float32)
    w = np.random.default_rng(5).standard_normal(24).astype(np.float32)
    lam = 0.05 * float(np.max(np.abs(Xty))) / 200
    got = lasso._cd_epoch(torch.from_numpy(w), torch.from_numpy(XtX),
                          torch.from_numpy(Xty), lam, 200.0).numpy()
    want = np.asarray(ref._cd_epoch(jnp.asarray(w), jnp.asarray(XtX),
                                    jnp.asarray(Xty), jnp.float32(lam),
                                    jnp.float32(200.0)))
    assert np.count_nonzero(want) > 3 and np.count_nonzero(want == 0) > 3
    np.testing.assert_allclose(got, want, rtol=EPOCH_RTOL, atol=1e-6)


def test_lasso_solve_zero_at_lambda_max():
    X, y = _planted()
    yc = y - y.mean()
    lam_max = np.max(np.abs(X.T @ yc)) / len(y)
    w = lasso.lasso_solve(X, yc, lam_max * 1.01, device="cpu")
    assert np.allclose(w, 0.0, atol=1e-6)


@needs_reference
def test_lasso_solve_matches_ols_at_zero_penalty():
    X, y = _planted(n=200, p=12, seed=1)
    yc = y - y.mean()
    w = lasso.lasso_solve(X, yc, 0.0, epochs=500, device="cpu")
    w_ols, *_ = np.linalg.lstsq(X, yc, rcond=None)
    np.testing.assert_allclose(w, w_ols, atol=5e-3)
    np.testing.assert_allclose(w, ref.lasso_solve(X, yc, 0.0, epochs=500),
                               rtol=PATH_RTOL, atol=PATH_ATOL)


@needs_reference
def test_lasso_path_matches_reference_on_planted_signal():
    X, y = _planted()
    names = [f"f{i}" for i in range(X.shape[1])]
    got = lasso.lasso_path(X, y, names, device="cpu")
    want = ref.lasso_path(X, y, names)
    np.testing.assert_array_equal(got.lambdas, want.lambdas)
    np.testing.assert_allclose(got.coefs, want.coefs, rtol=PATH_RTOL,
                               atol=PATH_ATOL)
    assert got.ranked_names()[:3] == ["f2", "f5", "f9"]
    assert got.order == want.order
    np.testing.assert_array_equal(got.entry_lambda, want.entry_lambda)


@needs_reference
def test_rank_levers_matches_reference_on_109_levers():
    R, y, names = _planted_levers()
    got = lasso.rank_levers(R, y, names, device="cpu")
    assert got == ref.rank_levers(R, y, names)
    assert got[:4] == ["L3", "L17", "L40", "L60"]
    assert len(got) == len(set(got))


def test_entry_order_is_first_lambda_above_threshold():
    coefs = np.array([[0.0, 0.0, 2e-8], [0.0, -1.0, 5e-9], [3.0, 1.0, 1.0]])
    order, entry = lasso.entry_order(coefs, np.array([3.0, 2.0, 1.0]))
    assert order == [2, 1, 0]
    np.testing.assert_array_equal(entry, [1.0, 2.0, 3.0])


def test_wrapper_runs_the_plain_version_on_cpu_and_counts_nothing():
    rng = np.random.default_rng(6)
    A = rng.standard_normal((40, 9))
    xtx = torch.from_numpy((A.T @ A).astype(np.float32))
    xty = torch.from_numpy(rng.standard_normal(9).astype(np.float32))
    lams = torch.tensor([2.0, 1.0, 0.1])
    before = lc.LAUNCHES
    c = lc.lasso_cd(xtx, xty, torch.zeros(9), lams, 40.0, epochs=30)
    assert lc.LAUNCHES == before and c.shape == (3, 9)
    # the last lambda's solution continues from the second's: warm start
    c2 = lc.lasso_cd_ref(xtx, xty, c[1].clone(), lams[2:], 40.0, epochs=30)
    torch.testing.assert_close(c[2], c2[0], rtol=0, atol=0)
    if not torch.cuda.is_available():   # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            lasso.lasso_path(A, rng.standard_normal(40), list("abcdefghi"))


def test_shared_memory_arm_and_cost_at_the_tuner_shape():
    assert lc.a_in_smem(218) and lc.a_in_smem(239)
    assert not lc.a_in_smem(240)
    assert lc.smem_bytes(218, True) == 4 * (3 * 224 + 218 * 218) <= \
        kbuild.MAX_SMEM
    assert lc.smem_bytes(300, False) == 4 * 3 * 320
    nbytes, flops = lc.cd_cost(218, 60, 514_044, 212_462)
    assert nbytes == 4 * (218 * 218 + 2 * 218 + 60 + 60 * 218)
    assert flops == 7 * 514_044 + 2 * 218 * 212_462 + 60
    assert lc.chain_updates(218, 60, 60) == 784_800


def _tuner_gram(R, y, device):
    """The path's inputs as ``rank_levers`` builds them from a lever
    matrix: normalised levers and their squares, the centred target."""
    Z, _, _ = lasso.normalise_levers(R)
    X, _ = lasso.polynomial_features(Z, [str(i) for i in range(R.shape[1])])
    return lasso.path_inputs(X, np.log(y - y.min() + 1.0), device=device)


def _scaled(got, want) -> float:
    g, w = np.asarray(got), np.asarray(want)
    return float(np.abs(g - w).max()) / max(1.0, float(np.abs(w).max()))


@needs_reference
@pytest.mark.parametrize("levers,n_lam", [(109, 60), (150, 6)],
                         ids=["p218", "p300"])
def test_mirror_matches_plain_version_and_reference_path(levers, n_lam):
    """The kernel's order (the gradient carried, c -= delta A[j] on a move,
    the exact epoch skip) on the tuner's planted 109-lever matrix and on p =
    300: within LASSO_TOL of the plain version and of the reference's
    ``lasso_path`` on the same lever matrix, entry order equal to both."""
    R, y, _ = _planted_levers(levers=levers, seed=levers)
    A, b, lams = _tuner_gram(R, y, "cpu")
    lams = lams[:n_lam]
    p = A.shape[0]
    lt = torch.as_tensor(lams, dtype=torch.float32)
    w0 = torch.zeros(p)
    got, counts = lc.lasso_cd_mirror(A, b, w0, lt, float(len(y)), epochs=60)
    assert got.shape == (n_lam, p) and 0 < counts["epochs"] <= 60 * n_lam
    assert counts["updates"] == counts["epochs"] * p
    assert 0 < counts["moves"] < counts["rounds"] <= \
        counts["moves"] + counts["epochs"] * -(-p // 32)
    plain = lc.lasso_cd_ref(A, b, w0, lt, float(len(y)), epochs=60).numpy()
    Z, _, _ = lasso.normalise_levers(R)
    X, names = lasso.polynomial_features(Z, [str(i) for i in range(levers)])
    want = ref.lasso_path(X, np.log(y - y.min() + 1.0), names)
    np.testing.assert_array_equal(want.lambdas[:n_lam], lams)
    g = got.numpy()
    order = lasso.entry_order(g, lams)[0]
    assert order[:2] == [3, 17]        # the two strongest planted levers
    for other in (plain, want.coefs[:n_lam]):
        assert _scaled(g, other) <= LASSO_TOL
        assert lasso.entry_order(other, lams)[0] == order


@pytest.mark.parametrize("levers", [None, 109], ids=["p24", "p218"])
def test_mirror_one_epoch_from_nonzero_w0(levers):
    """``lasso_solve``'s launch: one epoch from a nonzero w0 (c = b - A w0
    formed a column at a time), against the plain version's dot form."""
    if levers is None:
        X, y = _planted(n=200, p=24, seed=4)
        A, b, lams = lasso.path_inputs(X, y, device="cpu")
        n = 200
    else:
        R, y, _ = _planted_levers(levers=levers, seed=levers)
        A, b, lams = _tuner_gram(R, y, "cpu")
        n = len(y)
    rng = np.random.default_rng(7)
    w0 = rng.standard_normal(A.shape[0]).astype(np.float32)
    w0[rng.random(A.shape[0]) < 0.5] = 0.0
    lt = torch.as_tensor(lams[20:21], dtype=torch.float32)
    w0t = torch.from_numpy(w0)
    got, counts = lc.lasso_cd_mirror(A, b, w0t, lt, float(n), epochs=1)
    want = lc.lasso_cd_ref(A, b, w0t, lt, float(n), epochs=1)
    assert counts["epochs"] == 1
    assert np.count_nonzero(want.numpy()) > 3
    assert _scaled(got, want) <= LASSO_TOL


def _card_case(levers, n_lam):
    R, y, _ = _planted_levers(levers=levers, seed=levers)
    A, b, lams = _tuner_gram(R, y, torch.device("cuda"))
    return A, b, lams[:n_lam], len(y)


@pytest.mark.gpu
@pytest.mark.parametrize("levers,n_lam", [(109, 60), (150, 6), (125, 60)],
                         ids=["p218-shared", "p300-global",
                              "p250-global-registers"])
def test_cuda_kernel_matches_plain_version_on_the_card(levers, n_lam):
    """The tuner's shape (A in shared memory), p = 300 (A's rows from
    global memory, c in shared memory) and p = 250 (A from global memory, c
    in registers), on the card: bitwise equal to the mirror from w0 = 0,
    within LASSO_TOL of the plain version on the same tensors, entry order
    equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    A, b, lams, n = _card_case(levers, n_lam)
    assert lc.a_in_smem(A.shape[0]) == (levers == 109)
    w0 = torch.zeros(A.shape[0], device="cuda")
    lt = torch.as_tensor(lams, dtype=torch.float32, device="cuda")
    before = lc.LAUNCHES
    got = lc.lasso_cd(A, b, w0, lt, float(n), epochs=60)
    torch.cuda.synchronize()
    assert lc.LAUNCHES == before + 1
    mirror, _ = lc.lasso_cd_mirror(A, b, w0, lt, float(n), epochs=60)
    assert torch.equal(got.cpu(), mirror.cpu())
    want = lc.lasso_cd_ref(A, b, w0, lt, float(n), epochs=60)
    g, w = got.cpu().numpy(), want.cpu().numpy()
    assert _scaled(g, w) <= LASSO_TOL
    assert lasso.entry_order(g, lams)[0] == lasso.entry_order(w, lams)[0]


@pytest.mark.gpu
@pytest.mark.parametrize("levers", [109, 150], ids=["p218", "p300"])
def test_cuda_kernel_one_epoch_from_nonzero_w0(levers):
    """``lasso_solve``'s launch on the card: one epoch from a nonzero w0,
    within LASSO_TOL of the plain version and equal to the mirror, whose
    c = b - A w0 sums in the kernel's order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    A, b, lams, n = _card_case(levers, 60)
    rng = np.random.default_rng(8)
    w0 = rng.standard_normal(A.shape[0]).astype(np.float32)
    w0[rng.random(A.shape[0]) < 0.5] = 0.0
    w0 = torch.from_numpy(w0).cuda()
    lt = torch.as_tensor(lams[20:21], dtype=torch.float32, device="cuda")
    got = lc.lasso_cd(A, b, w0, lt, float(n), epochs=1)
    torch.cuda.synchronize()
    want = lc.lasso_cd_ref(A, b, w0, lt, float(n), epochs=1)
    assert _scaled(got.cpu(), want.cpu()) <= LASSO_TOL
    mirror, _ = lc.lasso_cd_mirror(A, b, w0, lt, float(n), epochs=1)
    assert torch.equal(got.cpu(), mirror.cpu())
