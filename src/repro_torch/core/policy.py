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

Acting has the reference's three front ends: ``act`` (one state) and
``act_batch`` (N states) draw on the host from a numpy ``default_rng(seed)``,
as the reference's do, so the same probabilities give the same actions;
``act_batch_device`` samples on the device from the agent's own
``PhiloxDraws`` through ``_sample_actions``. ``update`` pads host
``Trajectory``s onto ``update_batch``.

The update is one captured program per (episodes, steps) shape on the card
(``repro_torch.core.graphs``): the parameters and the rmsprop state live in
fixed buffers that every update overwrites in place, so the captured update
and the captured episode batches read them at fixed addresses.
``adopt_update`` takes leaves computed outside ``update_batch`` (the epoch
program's) into those buffers.

The reference keeps its weights as ``{"w1" (D, H), "b1", "w2" (H, A), "b2"}``;
``ReinforceAgent.load_reference_params`` carries such a dict (and
optionally the rmsprop state) into the module, transposing the weights to
``nn.Linear``'s (out, in) layout.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from repro_torch.core.graphs import Program
from repro_torch.engine.draws import PhiloxDraws
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


def policy_probs(policy: nn.Module, states) -> torch.Tensor:
    """Softmax action distribution of (..., D) states (no gradient)."""
    with torch.no_grad():
        return torch.softmax(policy(states), dim=-1)


def _pick(logits: torch.Tensor, draws, f: float, exploit: bool):
    """One action per row from (N, A) logits and the step's draws
    ``(g_full, g_sub, u_gate)`` (``None``: the argmax)."""
    if draws is None:
        return torch.argmax(logits, dim=-1)
    g_full, g_sub, u_gate = draws
    full_a = torch.argmax(logits + g_full, dim=-1)
    if not exploit:
        return full_a
    sub_a = torch.argmax(logits[:, :2] + g_sub, dim=-1)
    return torch.where(u_gate < f, sub_a, full_a)


def _sample_actions(policy: nn.Module, states: torch.Tensor, draws,
                    f: float, exploit: bool, greedy: bool = False,
                    mask: Optional[torch.Tensor] = None,
                    unmasked: bool = False):
    """Acting for one fused episode step over (N, D) states. ``greedy``
    takes the argmax action and reads no draws (the explore=False contract:
    deterministic, exactly replayable against the reference). Otherwise a
    Gumbel-max draw over the full action space, a renormalised draw over the
    top lever's two directions, and a per-row gate ``u < f`` picking the
    latter once ``exploit`` is on.

    ``mask`` (bool (N, A), True = allowed) is the §16 shield's trust-region
    action mask: a disallowed action's logit drops to -1e9 before the pick,
    greedy or not. ``unmasked=True`` also returns the pick the unmasked
    policy would have made — from the SAME draws, taken once (the
    reference re-samples with the same key; a stateful draw source must
    not be read twice) — as ``(a, a_free)``."""
    with torch.no_grad():
        logits = policy(states)
    g = None if greedy else draws.act(*logits.shape)
    masked = logits if mask is None else torch.where(mask, logits, -1e9)
    a = _pick(masked, g, f, exploit)
    if unmasked:
        return a, _pick(logits, g, f, exploit)
    return a


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


@dataclass
class Trajectory:
    states: list = field(default_factory=list)
    actions: list = field(default_factory=list)
    rewards: list = field(default_factory=list)

    def add(self, s, a, r) -> None:
        self.states.append(np.asarray(s, np.float32))
        self.actions.append(int(a))
        self.rewards.append(float(r))

    def __len__(self) -> int:
        return len(self.actions)


def discounted_returns(rewards: Sequence[float], gamma: float) -> np.ndarray:
    out = np.zeros(len(rewards), np.float32)
    acc = 0.0
    for t in range(len(rewards) - 1, -1, -1):
        acc = rewards[t] + gamma * acc
        out[t] = acc
    return out


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
        self._rng = np.random.default_rng(seed)
        #: the device sampler's draw source (``act_batch_device``)
        self._act_draws = PhiloxDraws(seed ^ 0x5EED, self.device)
        gen = torch.Generator().manual_seed(int(seed))
        self.policy = PolicyNet(state_dim, self.n_actions, hidden,
                                generator=gen).to(self.device)
        self.opt = rmsprop(lr=lr)
        #: the rmsprop state's fixed buffers (written in place by updates)
        self.opt_state = self.opt.init(self.params)
        #: (states shape, actions shape) -> (update program, its input
        #: buffers: states, actions, rewards, mask)
        self._updates: dict = {}

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
            nu = self.opt_state["nu"]
            with torch.no_grad():
                for ref, (name, transpose) in _REF_NAMES.items():
                    v = torch.as_tensor(np.asarray(opt_state["nu"][ref]),
                                        dtype=torch.float32)
                    nu[name].copy_(v.T if transpose else v)
                self.opt_state["count"].fill_(
                    int(np.asarray(opt_state["count"])))

    # -- acting --------------------------------------------------------------
    def action_decode(self, a: int) -> tuple[str, int]:
        """action id -> (lever name, direction ±1)."""
        lever = self.lever_names[a // 2]
        direction = 1 if a % 2 == 0 else -1
        return lever, direction

    def _probs_host(self, states: np.ndarray) -> np.ndarray:
        """The policy's action distribution of host states, back on the
        host as float32 (the reference's ``np.asarray(policy_probs...)``)."""
        st = torch.as_tensor(np.asarray(states, np.float32),
                             device=self.device)
        return policy_probs(self.policy, st).cpu().numpy()

    def act(self, state: np.ndarray, *, explore: bool = True) -> int:
        """Paper §2.4.2: the top lever is used f% of the time (its two
        directions, renormalised), the full softmax otherwise; drawn on the
        host from the agent's numpy generator."""
        probs = self._probs_host(state)
        probs = probs / probs.sum()
        if self.exploit_ready(explore=explore) and self._rng.uniform() < self.f:
            sub = probs[:2] + 1e-9  # actions 0/1 = top lever's +/- directions
            return int(self._rng.choice(2, p=sub / sub.sum()))
        return int(self._rng.choice(self.n_actions, p=probs))

    def act_batch(self, states: np.ndarray, *, explore: bool = True,
                  greedy: bool = False) -> np.ndarray:
        """One action per fleet cluster from (N, state_dim) states: one
        policy evaluation, then vectorised inverse-CDF draws on the host
        (the f-gate, the full distribution and the top lever's two
        directions). ``greedy`` takes the argmax and draws nothing."""
        probs = self._probs_host(states)
        probs = probs / probs.sum(axis=1, keepdims=True)
        if greedy:
            return np.argmax(probs, axis=1).astype(np.int64)
        N = probs.shape[0]
        u = self._rng.uniform(size=N)
        full_a = (np.cumsum(probs, axis=1) < u[:, None]).sum(axis=1)
        full_a = np.minimum(full_a, self.n_actions - 1)
        if not self.exploit_ready(explore=explore):
            return full_a.astype(np.int64)
        sub = probs[:, :2] + 1e-9
        sub = sub / sub.sum(axis=1, keepdims=True)
        u2 = self._rng.uniform(size=N)
        sub_a = (np.cumsum(sub, axis=1) < u2[:, None]).sum(axis=1)
        sub_a = np.minimum(sub_a, 1)
        gate = self._rng.uniform(size=N) < self.f
        return np.where(gate, sub_a, full_a).astype(np.int64)

    def act_batch_device(self, states, *, explore: bool = True,
                         greedy: bool = False, mask=None) -> torch.Tensor:
        """``act_batch`` on the device: the forward pass, the f-gate and the
        Gumbel-max draws (from the agent's ``PhiloxDraws``) never leave it.
        ``mask`` rides into the masked pick (§16 shield). Returns the (N,)
        int64 actions on the agent's device."""
        st = torch.as_tensor(states, dtype=torch.float32, device=self.device)
        if mask is not None:
            mask = torch.as_tensor(mask, dtype=torch.bool, device=self.device)
        return _sample_actions(self.policy, st, self._act_draws,
                               float(self.f),
                               self.exploit_ready(explore=explore),
                               greedy=greedy, mask=mask)

    def exploit_ready(self, *, explore: bool = True) -> bool:
        """The f-gate warm-up state: exploitation only after
        ``f_warmup_updates`` policy updates."""
        return bool(explore and self.n_updates >= self.f_warmup_updates)

    # -- learning (Algorithm 1) -----------------------------------------------
    def update_batch_async(self, states, actions, rewards, mask=None):
        """One REINFORCE batch update from device-resident (N, T) episode
        tensors. The update is enqueued on the device at once — its
        program for this shape (captured on the card) overwrites the
        parameters and the rmsprop state in place — and the returned thunk
        blocks on the reported scalars, so the caller's host work between
        the two overlaps the device update."""
        dev = self.device
        states = torch.as_tensor(states, dtype=torch.float32, device=dev)
        actions = torch.as_tensor(actions, device=dev).to(torch.int64)
        rewards = torch.as_tensor(rewards, dtype=torch.float32, device=dev)
        if mask is None:
            mask = torch.ones(actions.shape, dtype=torch.float32, device=dev)
        else:
            mask = torch.as_tensor(mask, dtype=torch.float32, device=dev)
        key = (tuple(states.shape), tuple(actions.shape))
        if key not in self._updates:
            bufs = (torch.empty_like(states), torch.empty_like(actions),
                    torch.empty_like(rewards), torch.empty_like(mask))
            self._updates[key] = (Program(
                ("update",) + key, lambda: self._update_in_place(*bufs),
                dev), bufs)
        prog, bufs = self._updates[key]
        for buf, x in zip(bufs, (states, actions, rewards, mask)):
            buf.copy_(x)
        # the outputs live in the program's memory: copy them before the
        # next update (a pipeline enqueues it before this thunk runs)
        loss, first = (x.clone() for x in prog())
        steps = mask.sum()
        self.n_updates += 1
        episodes = int(actions.shape[0])

        def stats() -> dict:
            return {"pg_loss": float(loss), "mean_return": float(first),
                    "episodes": episodes, "steps": int(steps.item())}

        return stats

    def _update_in_place(self, states, actions, rewards, mask):
        """``_update_step`` with the new parameters and rmsprop state
        written into the agent's own buffers. Returns (loss, first)."""
        own = self.params
        new, opt_state, loss, first = _update_step(
            self.policy, own, self.opt_state, states, actions, rewards, mask,
            opt=self.opt, gamma=self.gamma, entropy_beta=self.entropy_beta)
        self._write_state(new, opt_state)
        return loss, first

    def _write_state(self, params: dict, opt_state: dict) -> None:
        """Copy parameter and rmsprop leaves into the agent's buffers (a
        leaf that already is the buffer is left as it is)."""
        with torch.no_grad():
            pairs = [(self.params[k], params[k]) for k in params]
            pairs += [(self.opt_state["nu"][k], v)
                      for k, v in opt_state["nu"].items()]
            pairs.append((self.opt_state["count"], opt_state["count"]))
            for dst, src in pairs:
                if dst is not src:
                    dst.copy_(src)

    def adopt_update(self, params: dict, opt_state: dict, k: int = 1) -> None:
        """Adopt post-update parameters and rmsprop state computed outside
        ``update_batch`` (the epoch program runs ``k`` updates on the
        device); the exploit warm-up bookkeeping advances by ``k``."""
        self._write_state(params, opt_state)
        self.n_updates += int(k)

    def update_batch(self, states, actions, rewards, mask=None) -> dict:
        """``update_batch_async`` and wait for its stats."""
        return self.update_batch_async(states, actions, rewards, mask)()

    def update(self, episodes: Sequence[Trajectory]) -> dict:
        """One REINFORCE batch update from N host episodes (the per-step
        baseline is the across-episode mean return at that step): pads the
        trajectories into (N, T) arrays with a validity mask and runs the
        same update as the fused loop (``update_batch``)."""
        eps = [e for e in episodes if len(e)]
        if not eps:
            return {"pg_loss": 0.0, "mean_return": 0.0}
        N = len(eps)
        T = max(len(e) for e in eps)
        states = np.zeros((N, T, self.state_dim), np.float32)
        actions = np.zeros((N, T), np.int64)
        rewards = np.zeros((N, T), np.float32)
        mask = np.zeros((N, T), np.float32)
        for i, e in enumerate(eps):
            L = len(e)
            states[i, :L] = np.stack(e.states)
            actions[i, :L] = e.actions
            rewards[i, :L] = e.rewards
            mask[i, :L] = 1.0
        return self.update_batch(states, actions, rewards, mask)
