"""Shadow → canary → promote/rollback state machine (DESIGN.md §13).

The gate is deliberately *conservative* (ContTune, arXiv 2309.12239): a
challenger config must beat the incumbent's canary reward by a relative
margin in K CONSECUTIVE evaluation cycles before it is promoted; a single
loss demotes it (back to shadowing for a new candidate), and an SLO breach
during canary rolls it back immediately regardless of reward — a config
that breached while under canary can never reach the live fleet.

The gate itself is pure host-side bookkeeping: the controller feeds it
(candidate_reward, incumbent_reward, breached) per cycle and acts on the
returned decision. ``log`` is the append-only promotion history that rides
every checkpoint (``ServeController.checkpoint``) and the crash-resume
equality assertions in tests/test_serve_crash.py.
"""
from __future__ import annotations

from typing import Optional

#: decisions ``CanaryGate.decide`` can return
DECISIONS = ("promote", "hold", "demote", "rollback")


class CanaryGate:
    """K-consecutive-wins margin gate over one challenger config at a time."""

    def __init__(self, k: int = 2, margin: float = 0.02):
        assert k >= 1 and margin >= 0.0
        self.k = int(k)
        self.margin = float(margin)
        self.challenger: Optional[dict] = None
        self.streak = 0
        self.adopted_cycle: Optional[int] = None
        #: append-only event history: adopt / hold / promote / demote /
        #: rollback rows (checkpointed; compared bitwise on crash-resume)
        self.log: list[dict] = []

    # ------------------------------------------------------------ lifecycle
    def adopt(self, config: dict, *, cycle: int,
              shadow_reward: Optional[float] = None) -> None:
        """Install a new challenger (only when none is under evaluation)."""
        assert self.challenger is None, "a challenger is already under canary"
        self.challenger = dict(config)
        self.streak = 0
        self.adopted_cycle = cycle
        self.log.append({"cycle": cycle, "event": "adopt",
                         "config": dict(config),
                         "shadow_reward": shadow_reward})

    def beats(self, cand_reward: float, inc_reward: float) -> bool:
        """Margin test: the challenger must beat the incumbent by
        ``margin`` RELATIVE to the incumbent's reward magnitude (rewards
        are negative latencies, so an absolute margin would mean different
        strictness at different operating points)."""
        return (cand_reward - inc_reward
                >= self.margin * max(abs(inc_reward), 1e-9))

    def decide(self, cand_reward: float, inc_reward: float, breached: bool,
               *, cycle: int) -> str:
        """One canary evaluation's verdict. Returns one of ``DECISIONS``;
        ``promote``/``demote``/``rollback`` clear the challenger (the
        promoted config is handed back via ``last_promoted``)."""
        assert self.challenger is not None, "no challenger under canary"
        entry = {"cycle": cycle, "config": dict(self.challenger),
                 "cand_reward": float(cand_reward),
                 "inc_reward": float(inc_reward)}
        if breached:
            # SLO breach wins over any reward comparison: never promote a
            # config that breached while under canary
            self._clear()
            self.log.append({**entry, "event": "rollback"})
            return "rollback"
        if not self.beats(cand_reward, inc_reward):
            self._clear()
            self.log.append({**entry, "event": "demote"})
            return "demote"
        self.streak += 1
        if self.streak >= self.k:
            self.last_promoted = dict(self.challenger)
            self._clear()
            self.log.append({**entry, "event": "promote", "streak": self.k})
            return "promote"
        self.log.append({**entry, "event": "hold", "streak": self.streak})
        return "hold"

    def force_demote(self, *, cycle: int, reason: str = "") -> None:
        """Clear the challenger WITHOUT a canary evaluation — the §16
        breach-budget trip: the shadow fleet ran its per-episode breach
        budget to zero while this challenger was queued, so the controller
        demotes it on the spot rather than spend a canary cycle on a
        candidate surfaced by an exploration phase that was breaching.
        Logged as a ``demote`` so the ``demote_cooldown`` blocklist
        applies to the config as usual."""
        assert self.challenger is not None, "no challenger under canary"
        self.log.append({"cycle": cycle, "event": "demote",
                         "config": dict(self.challenger),
                         "cand_reward": None, "inc_reward": None,
                         "reason": reason or "breach_budget"})
        self._clear()

    def _clear(self) -> None:
        self.challenger = None
        self.streak = 0
        self.adopted_cycle = None

    # ---------------------------------------------------------- checkpoint
    def state(self) -> dict:
        return {"k": self.k, "margin": self.margin,
                "challenger": self.challenger, "streak": self.streak,
                "adopted_cycle": self.adopted_cycle, "log": self.log}

    def load_state(self, st: dict) -> None:
        self.k = int(st["k"])
        self.margin = float(st["margin"])
        self.challenger = (dict(st["challenger"])
                           if st["challenger"] is not None else None)
        self.streak = int(st["streak"])
        self.adopted_cycle = st["adopted_cycle"]
        self.log = [dict(e) for e in st["log"]]

    def promotions(self) -> list[dict]:
        return [e for e in self.log if e["event"] == "promote"]

    def rollbacks(self) -> list[dict]:
        return [e for e in self.log if e["event"] == "rollback"]
