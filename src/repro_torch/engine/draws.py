"""Random draws of the torch fleet engine and the fused episode loop, kept
apart from the maths that consumes them (ROADMAP: "Port code should keep
random draws separate").

The reference derives every draw from a threefry key tree: one key per
engine window (``DeviceFleetEngine._next_key``), split three ways for the
tick, lane and emission draws (the scan path draws its p99 lanes from the
lane key, in its own (T, N, Sp) layout); one key per episode batch, folded
per step and split into act / load / window keys. The port's consumers ask a *draw
source* for the same draws by the same addresses:

    src.window()            -> WindowDraws      one engine observe window
    src.episode().step(t)   -> StepDraws        step t of one episode batch

    WindowDraws.tick_bits(T, N)      (T, 2, N) uint32 values, as int64
    WindowDraws.lane_bits(T, S, N)   (T, S, N)       the kernel path's lanes
    WindowDraws.p99_bits(T, N, Sp)   (T, N, Sp)      the scan path's p99 lanes
    WindowDraws.emit_bits(shape)     ``shape`` (pairs of 16-bit normals)
    StepDraws.act(N, A)              (gumbel (N, A), gumbel (N, 2), U(0,1) (N,))
    StepDraws.load(N)                (N,) standard normals
    StepDraws.window()               the step's WindowDraws

``PhiloxDraws`` is the default source: one ``torch.Generator`` (Philox on
CUDA) whose address tree collapses to a single stream. A test can pass any
object with these methods — e.g. one that replays the reference's threefry
draws — and nothing on the main path needs to know.

**Shards (DESIGN.md §11).** On a fleet mesh each rank runs the episode on
its block of clusters and draws from ``src.for_shard(r)``, as the
reference folds the shard's ``axis_index`` into the episode key (and the
unsharded program folds 0). Shard 0 is the source itself, so a mesh of one
rank draws today's stream bit for bit; every other ordinal gets a stream
of its own (``PhiloxDraws(seed, device, shard=r)``, seeded from
``(seed, r)``). The engine's own stream (its observe windows) advances on
shard 0 only; the runner copies rank 0's stream to every rank after each
epoch (``get_state`` / ``set_state``), so the whole fleet, its stream
included, stays the same on every rank.

A CUDA graph draws from a generator other than the default one only when
the generator is registered with it (``PhiloxDraws.register``); each replay
then takes the Philox offsets the eager calls would have taken, in the same
order, so a replayed program and its eager run draw the same numbers. Only
``PhiloxDraws`` can be captured: a source that draws on the host (the tests'
threefry replay) runs eagerly, on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

#: smallest positive normal f32: keeps U(0,1) away from 0 under the Gumbel
#: transform's double log
_TINY = float(torch.finfo(torch.float32).tiny)


class PhiloxDraws:
    """Draw source backed by one seeded ``torch.Generator`` on ``device``.
    Every address of the draw tree returns the source itself, so all draws
    come off the one stream in call order. ``shard`` > 0 seeds the stream
    from ``(seed, shard)`` instead (a fleet mesh's other ranks)."""

    def __init__(self, seed: int, device, shard: int = 0):
        self.device = torch.device(device)
        self.seed, self.shard = int(seed), int(shard)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(self.seed if not self.shard else int(
            np.random.SeedSequence([self.seed, self.shard]).generate_state(
                1, np.uint64)[0] >> np.uint64(1)))
        self._shards: dict = {}

    def for_shard(self, shard: int) -> "PhiloxDraws":
        """The draw source of fleet-mesh shard ``shard``: this source for
        shard 0, else a stream of its own, made once."""
        if shard == self.shard:
            return self
        if shard not in self._shards:
            self._shards[shard] = PhiloxDraws(self.seed, self.device, shard)
        return self._shards[shard]

    def get_state(self) -> torch.Tensor:
        """The generator's state, a uint8 CPU tensor (seed and offset on
        CUDA, the Mersenne state on the CPU)."""
        return self.gen.get_state()

    def set_state(self, state: torch.Tensor) -> None:
        """Restore in place: a CUDA graph that registered this generator
        keeps drawing from it."""
        self.gen.set_state(state)

    def register(self, graph) -> None:
        """Let ``graph`` (a ``torch.cuda.CUDAGraph`` before its capture)
        draw from this source: every replay advances the stream by what the
        captured calls take."""
        graph.register_generator_state(self.gen)

    # the address tree (window / episode / step) is one stream here
    def window(self) -> "PhiloxDraws":
        return self

    def episode(self) -> "PhiloxDraws":
        return self

    def step(self, t: int) -> "PhiloxDraws":
        return self

    def _bits(self, shape) -> torch.Tensor:
        return torch.randint(0, 2 ** 32, tuple(shape), dtype=torch.int64,
                             generator=self.gen, device=self.device)

    def _uniform(self, shape) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self.gen, device=self.device)

    def tick_bits(self, T: int, N: int) -> torch.Tensor:
        return self._bits((T, 2, N))

    def lane_bits(self, T: int, S: int, N: int) -> torch.Tensor:
        return self._bits((T, S, N))

    def p99_bits(self, T: int, N: int, Sp: int) -> torch.Tensor:
        return self._bits((T, N, Sp))

    def emit_bits(self, shape) -> torch.Tensor:
        return self._bits(shape)

    def act(self, N: int, A: int):
        gumbel = lambda shape: -torch.log(-torch.log(
            torch.clamp(self._uniform(shape), min=_TINY)))
        return gumbel((N, A)), gumbel((N, 2)), self._uniform((N,))

    def load(self, N: int) -> torch.Tensor:
        return torch.randn((N,), generator=self.gen, device=self.device)
