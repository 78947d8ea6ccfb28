"""A fleet mesh's serve checkpoint, taken mid-run and restored in a fresh
controller, continues bit for bit (DESIGN.md §11, §13): the crash-resume
pin of ``tests/test_torch_serve_crash.py`` on 2 gloo ranks
(``tests/test_torch_fleet_mesh.py``'s harness). Run A goes 4 cycles
uninterrupted; run B checkpoints after 2; a fresh controller C restores
it and runs 2 more. Each rank of the sharded shadow fleet draws its
block's windows from a stream of its own (``PhiloxDraws.for_shard``), so
the checkpoint must hold every rank's stream, not only rank 0's: on each
rank, C must end where A ends (``assert_same_service``) with its shard's
stream where A's is.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_fleet_mesh import _spawn  # noqa: E402
from test_torch_serve_crash import (FROZEN, LEVERS, METRICS,  # noqa: E402
                                    _wl, assert_same_service)


def _controller(ckdir=None, *, mesh):
    """``tests/test_torch_serve_crash.py``'s controller on ``mesh``."""
    from repro_torch.serve import ServeController

    return ServeController([_wl(i) for i in range(4)],
                           metrics=METRICS, levers=LEVERS, backend="torch",
                           seed=0, window_s=240.0, steps_per_episode=2,
                           k_promote=2, margin=0.0, canary_pairs=2,
                           n_live=2, bin_kw=FROZEN, mesh=mesh,
                           checkpoint_dir=ckdir, device="cpu",
                           slo_ms=20_000.0, window_impl="kernel")


def _resume(rank, world, ckdir):
    from repro_torch.distribution.sharding import fleet_mesh

    torch.set_num_threads(1)
    mesh = fleet_mesh()
    A = _controller(mesh=mesh)
    A.run(4)
    B = _controller(ckdir, mesh=mesh)
    B.run(2)
    B.checkpoint()
    B.run(2)
    C = _controller(ckdir, mesh=mesh)
    assert C.restore(step=2) == 2
    C.run(2)
    assert_same_service(A, C, rows_after=2)
    shard = [env._dev.draws.for_shard(rank).get_state()
             for env in (A.shadow_env, C.shadow_env)]
    assert torch.equal(*shard), f"rank {rank}: its shard's stream differs"
    assert A.cfgr.agent.n_updates == 4
    return True


def test_a_resumed_fleet_mesh_continues_bit_for_bit(tmp_path):
    assert _spawn(_resume, 2, tmp_path, str(tmp_path / "ck")) == [True, True]
