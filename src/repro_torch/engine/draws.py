"""Random draws of the torch fleet engine and the fused episode loop, kept
apart from the maths that consumes them (ROADMAP: "Port code should keep
random draws separate").

The reference derives every draw from a threefry key tree: one key per
engine window (``DeviceFleetEngine._next_key``), split three ways for the
tick, lane and emission draws; one key per episode batch, folded per step
and split into act / load / window keys. The port's consumers ask a *draw
source* for the same draws by the same addresses:

    src.window()            -> WindowDraws      one engine observe window
    src.episode().step(t)   -> StepDraws        step t of one episode batch

    WindowDraws.tick_bits(T, N)      (T, 2, N) uint32 values, as int64
    WindowDraws.lane_bits(T, S, N)   (T, S, N)
    WindowDraws.emit_bits(shape)     ``shape`` (pairs of 16-bit normals)
    StepDraws.act(N, A)              (gumbel (N, A), gumbel (N, 2), U(0,1) (N,))
    StepDraws.load(N)                (N,) standard normals
    StepDraws.window()               the step's WindowDraws

``PhiloxDraws`` is the default source: one ``torch.Generator`` (Philox on
CUDA) whose address tree collapses to a single stream. A test can pass any
object with these methods — e.g. one that replays the reference's threefry
draws — and nothing on the main path needs to know.
"""
from __future__ import annotations

import torch

#: smallest positive normal f32: keeps U(0,1) away from 0 under the Gumbel
#: transform's double log
_TINY = float(torch.finfo(torch.float32).tiny)


class PhiloxDraws:
    """Draw source backed by one seeded ``torch.Generator`` on ``device``.
    Every address of the draw tree returns the source itself, so all draws
    come off the one stream in call order."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))

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

    def emit_bits(self, shape) -> torch.Tensor:
        return self._bits(shape)

    def act(self, N: int, A: int):
        gumbel = lambda shape: -torch.log(-torch.log(
            torch.clamp(self._uniform(shape), min=_TINY)))
        return gumbel((N, A)), gumbel((N, 2)), self._uniform((N,))

    def load(self, N: int) -> torch.Tensor:
        return torch.randn((N,), generator=self.gen, device=self.device)
