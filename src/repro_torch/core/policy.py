"""REINFORCE policy-gradient configurator (paper §2.4.2, §3, Algorithm 1), on
PyTorch.

* Policy network: an ``nn.Module`` with ONE fully-connected hidden layer of
  20 neurons (paper §3) over the flattened heat-map state — ``Linear(D, 20)``
  → tanh → ``Linear(20, A)``; softmax over actions.
* Actions: (lever, direction) pairs over the selected levers — 2 per lever.
* Exploitation factor f: with probability f the action is restricted to the
  TOP-ranked lever's two directions; with 1-f the full distribution is
  sampled (paper §2.4.2, §4.5). Sampling is Gumbel-max on draws taken from
  the step's draw source (``repro_torch.engine.draws``).
* Training: REINFORCE with a per-step baseline averaged across the N
  episodes of the batch (Algorithm 1), gamma 1 by default, rmsprop(lr=1e-3)
  (paper §3); the gradient comes from ``torch.autograd``.

The reference keeps its weights as ``{"w1" (D, H), "b1", "w2" (H, A), "b2"}``;
``ReinforceAgent.load_reference_params`` carries such a dict (and
optionally the rmsprop state) into the module, transposing the weights to
``nn.Linear``'s (out, in) layout.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from repro_torch.optim import rmsprop

#: reference parameter name -> (module parameter name, transposed?)
_REF_NAMES = {"w1": ("l1.weight", True), "b1": ("l1.bias", False),
              "w2": ("l2.weight", True), "b2": ("l2.bias", False)}


class PolicyNet(nn.Module):
    """The paper's policy MLP. Weights start ~N(0, 1/fan_in), biases at 0,
    like the reference's ``init_policy``, from an explicit generator."""

    def __init__(self, state_dim: int, n_actions: int, hidden: int = 20, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.l1 = nn.Linear(state_dim, hidden)
        self.l2 = nn.Linear(hidden, n_actions)
        with torch.no_grad():
            for lin in (self.l1, self.l2):
                fan_in = lin.weight.shape[1]
                lin.weight.copy_(torch.randn(lin.weight.shape,
                                             generator=generator)
                                 / np.sqrt(fan_in))
                lin.bias.zero_()

    def forward(self, states: torch.Tensor) -> torch.Tensor:
        return self.l2(torch.tanh(self.l1(states)))


def policy_logits(policy: nn.Module, states: torch.Tensor,
                  params: Optional[dict] = None) -> torch.Tensor:
    """Logits of (..., D) states; ``params`` overrides the module's own
    parameters (the functional form the update differentiates)."""
    if params is None:
        return policy(states)
    return functional_call(policy, params, (states,))


def _sample_actions(policy: nn.Module, states: torch.Tensor, draws,
                    f: float, exploit: bool,
                    greedy: bool = False) -> torch.Tensor:
    """Acting for one fused episode step over (N, D) states. ``greedy``
    takes the argmax action and reads no draws (the explore=False contract:
    deterministic, exactly replayable against the reference). Otherwise a
    Gumbel-max draw over the full action space, a renormalised draw over the
    top lever's two directions, and a per-row gate ``u < f`` picking the
    latter once ``exploit`` is on."""
    with torch.no_grad():
        logits = policy(states)
    if greedy:
        return torch.argmax(logits, dim=-1)
    g_full, g_sub, u_gate = draws.act(*logits.shape)
    full_a = torch.argmax(logits + g_full, dim=-1)
    if not exploit:
        return full_a
    sub_a = torch.argmax(logits[:, :2] + g_sub, dim=-1)
    return torch.where(u_gate < f, sub_a, full_a)


def _batch_pg_loss(policy, params: dict, states, actions, advantages, mask,
                   entropy_beta: float) -> torch.Tensor:
    """-(1/N) sum_t log pi(a_t|s_t) * adv_t over a padded (N, T) batch,
    minus a small entropy bonus (premature-collapse guard)."""
    logits = policy_logits(policy, states, params)
    logp = torch.log_softmax(logits, dim=-1)
    chosen = torch.gather(logp, -1, actions[..., None])[..., 0]
    msum = torch.clamp(mask.sum(), min=1.0)
    pg = -(chosen * advantages * mask).sum() / msum
    ent = -(torch.exp(logp) * logp).sum(-1)
    ent = (ent * mask).sum() / msum
    return pg - entropy_beta * ent


def discounted_returns_device(rewards: torch.Tensor, gamma: float) -> torch.Tensor:
    """Discounted returns over a padded (N, T) batch, a reverse loop over
    steps (padded, reward-0 tail steps contribute nothing)."""
    out = torch.empty_like(rewards)
    acc = torch.zeros_like(rewards[:, 0])
    for t in range(rewards.shape[1] - 1, -1, -1):
        acc = rewards[:, t] + gamma * acc
        out[:, t] = acc
    return out


def _update_step(policy, params: dict, opt_state: dict, states, actions,
                 rewards, mask, *, opt, gamma: float, entropy_beta: float):
    """One whole Algorithm-1 policy update: returns-discounting, the
    across-episode per-step baseline, masked advantage scale-normalisation,
    the policy gradient (autograd) and the rmsprop step. Returns the new
    parameter dict, the optimizer state, the loss at the new parameters and
    the mean first-step return."""
    returns = discounted_returns_device(rewards, gamma)
    denom = torch.clamp(mask.sum(dim=0), min=1.0)
    baseline = (returns * mask).sum(dim=0) / denom
    adv = (returns - baseline[None, :]) * mask
    # scale-normalise advantages, but floor the divisor at a fraction of
    # the reward magnitude: when rewards plateau (std -> 0) a bare /std
    # would amplify pure noise into full-strength updates
    msum = torch.clamp(mask.sum(), min=1.0)
    mean_adv = adv.sum() / msum
    std = torch.sqrt(torch.clamp(
        (((adv - mean_adv) ** 2) * mask).sum() / msum, min=0.0))
    ret_mean = (returns * mask).sum() / msum
    scale = torch.clamp(torch.maximum(std, 0.05 * torch.abs(ret_mean)),
                        min=1e-8)
    adv = adv / scale
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    loss = _batch_pg_loss(policy, leaves, states, actions, adv, mask,
                          entropy_beta)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    with torch.no_grad():
        new_params, opt_state = opt.update(
            grads, opt_state, {k: p.detach() for k, p in params.items()})
        loss = _batch_pg_loss(policy, new_params, states, actions, adv, mask,
                              entropy_beta)
        first = (returns[:, 0] * mask[:, 0]).sum() \
            / torch.clamp(mask[:, 0].sum(), min=1.0)
    return new_params, opt_state, loss, first


class ReinforceAgent:
    """The paper's configurator: acts on a state, learns from episode batches."""

    def __init__(
        self,
        state_dim: int,
        lever_names: Sequence[str],
        *,
        device,
        f_exploit: float = 0.8,
        gamma: float = 1.0,
        lr: float = 1e-3,
        hidden: int = 20,
        seed: int = 0,
        entropy_beta: float = 0.01,
        f_warmup_updates: int = 2,
    ):
        self.lever_names = list(lever_names)  # ranked order: [0] = top lever
        self.n_actions = 2 * len(self.lever_names)
        self.state_dim = state_dim
        self.device = torch.device(device)
        self.f = f_exploit
        self.gamma = gamma
        self.entropy_beta = entropy_beta
        self.f_warmup_updates = f_warmup_updates
        self.n_updates = 0
        gen = torch.Generator().manual_seed(int(seed))
        self.policy = PolicyNet(state_dim, self.n_actions, hidden,
                                generator=gen).to(self.device)
        self.opt = rmsprop(lr=lr)
        self.opt_state = self.opt.init(self.params)

    @property
    def params(self) -> dict:
        """The module's parameters by name (live tensors, no copy)."""
        return dict(self.policy.named_parameters())

    def load_reference_params(self, params: dict,
                              opt_state: Optional[dict] = None) -> None:
        """Load the reference agent's ``{"w1", "b1", "w2", "b2"}`` numpy
        arrays (and optionally its rmsprop ``{"nu": {...}, "count"}``) into
        this agent, transposing the weights to ``nn.Linear``'s layout."""
        own = self.params
        with torch.no_grad():
            for ref, (name, transpose) in _REF_NAMES.items():
                v = torch.tensor(np.asarray(params[ref]), dtype=torch.float32)
                own[name].copy_(v.T if transpose else v)
        if opt_state is not None:
            nu = {}
            for ref, (name, transpose) in _REF_NAMES.items():
                v = torch.as_tensor(np.asarray(opt_state["nu"][ref]),
                                    dtype=torch.float32, device=self.device)
                nu[name] = v.T.contiguous() if transpose else v
            self.opt_state = {"nu": nu, "count": torch.as_tensor(
                int(np.asarray(opt_state["count"])), dtype=torch.int32,
                device=self.device)}

    # -- acting --------------------------------------------------------------
    def action_decode(self, a: int) -> tuple[str, int]:
        """action id -> (lever name, direction ±1)."""
        lever = self.lever_names[a // 2]
        direction = 1 if a % 2 == 0 else -1
        return lever, direction

    def exploit_ready(self, *, explore: bool = True) -> bool:
        """The f-gate warm-up state: exploitation only after
        ``f_warmup_updates`` policy updates."""
        return bool(explore and self.n_updates >= self.f_warmup_updates)

    # -- learning (Algorithm 1) -----------------------------------------------
    def update_batch_async(self, states, actions, rewards, mask=None):
        """One REINFORCE batch update from device-resident (N, T) episode
        tensors. The update is enqueued on the device at once — the policy
        module's parameters are overwritten IN PLACE with the new values —
        and the returned thunk blocks on the reported scalars, so the
        caller's host work between the two overlaps the device update."""
        dev = self.device
        states = torch.as_tensor(states, dtype=torch.float32, device=dev)
        actions = torch.as_tensor(actions, device=dev).to(torch.int64)
        rewards = torch.as_tensor(rewards, dtype=torch.float32, device=dev)
        if mask is None:
            mask = torch.ones(actions.shape, dtype=torch.float32, device=dev)
        else:
            mask = torch.as_tensor(mask, dtype=torch.float32, device=dev)
        own = self.params
        new, self.opt_state, loss, first = _update_step(
            self.policy, own, self.opt_state, states, actions, rewards, mask,
            opt=self.opt, gamma=self.gamma, entropy_beta=self.entropy_beta)
        with torch.no_grad():
            for k, p in own.items():
                p.copy_(new[k])
        self.n_updates += 1
        episodes = int(actions.shape[0])

        def stats() -> dict:
            return {"pg_loss": float(loss), "mean_return": float(first),
                    "episodes": episodes, "steps": int(mask.sum().item())}

        return stats

    def update_batch(self, states, actions, rewards, mask=None) -> dict:
        """``update_batch_async`` and wait for its stats."""
        return self.update_batch_async(states, actions, rewards, mask)()
