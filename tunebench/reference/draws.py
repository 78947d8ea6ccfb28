"""The plain reference's draw source: the random numbers the program draws,
read again from the same seed.

The program's fleet engine draws every tick, lane, emission, action and
loading number from one seeded ``torch.Generator`` on its device (Philox on
a card), whose address tree (window, episode, step) collapses to a single
stream, in call order. Its seed is derived from the clusters' seeds, which
the run's inputs hand to both sides (``harness/inputs.py``). ``SeedDraws``
is a generator of that seed on the same device, asked for the same shapes
in the same order, so the reference reads the numbers the program read. A
CUDA graph that registered the program's generator takes, at every replay,
the Philox offsets its eager calls would have taken, so a captured program
and the reference's eager calls draw the same numbers.
"""
from __future__ import annotations

import torch

#: smallest positive normal f32: keeps U(0,1) away from 0 under the Gumbel
#: transform's double log
_TINY = float(torch.finfo(torch.float32).tiny)


class SeedDraws:
    """Draw source backed by one seeded generator on ``device``."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.seed = int(seed)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(self.seed)

    def register(self, graph) -> None:
        graph.register_generator_state(self.gen)

    # the address tree (window / episode / step) is one stream
    def window(self) -> "SeedDraws":
        return self

    def episode(self) -> "SeedDraws":
        return self

    def step(self, t: int) -> "SeedDraws":
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
        def gumbel(shape):
            u = torch.clamp(self._uniform(shape), min=_TINY)
            return -torch.log(-torch.log(u))
        return gumbel((N, A)), gumbel((N, 2)), self._uniform((N,))

    def load(self, N: int) -> torch.Tensor:
        return torch.randn((N,), generator=self.gen, device=self.device)
