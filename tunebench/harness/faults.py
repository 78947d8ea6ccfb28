"""Faults planted in the program under test, for the readings that set the
limits of ``correct`` and for the tests that see ``correct`` come out
false. Each ``plant_<name>(cfgr)`` breaks the built configurator in this
process only (instance attributes and the one module attribute named, all
restored by ``restore``):

* ``state_unchanged``: each policy update computes its loss and leaves the
  parameters and the optimizer state as they were;
* ``half_batch``: each update takes the first half of the episodes and the
  mean over them;
* ``answer_altered``: the window step reports cluster 0's mean latency half
  as large again as it computed it (the reward of one cluster a step).

A one-chip cell has no exchange between chips to leave out.
"""
from __future__ import annotations

import torch


def plant_state_unchanged(cfgr):
    from repro_torch.core.policy import _update_step

    agent = cfgr.agent

    def update(states, actions, rewards, mask):
        _, _, loss, first = _update_step(
            agent.policy, agent.params, agent.opt_state, states, actions,
            rewards, mask, opt=agent.opt, gamma=agent.gamma,
            entropy_beta=agent.entropy_beta)
        return loss, first

    agent._update_in_place = update
    return lambda: agent.__dict__.pop("_update_in_place", None)


def plant_half_batch(cfgr):
    agent = cfgr.agent
    orig = agent._update_in_place

    def update(states, actions, rewards, mask):
        h = states.shape[0] // 2
        return orig(states[:h], actions[:h], rewards[:h], mask[:h])

    agent._update_in_place = update
    return lambda: agent.__dict__.pop("_update_in_place", None)


def plant_answer_altered(cfgr):
    from repro_torch.core import device_loop

    orig = device_loop.build_step_window

    def build(*a, **kw):
        step = orig(*a, **kw)

        def step_window(*sa, **skw):
            carry, stats = step(*sa, **skw)
            m = stats["mean_ms"]
            first = torch.arange(m.shape[0], device=m.device) == 0
            return carry, dict(stats, mean_ms=torch.where(first, m * 1.5, m))

        return step_window

    device_loop.build_step_window = build
    return lambda: setattr(device_loop, "build_step_window", orig)


PLANTS = {"state_unchanged": plant_state_unchanged,
          "half_batch": plant_half_batch,
          "answer_altered": plant_answer_altered}
