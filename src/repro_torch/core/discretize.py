"""Dynamic lever discretisation (paper §2.4.1, after [55]).

Each continuous lever is binned over [min, max] with an initial bin size
delta = |max - min| / 10 (10 bins). The binning then adapts to how the RL
configurator uses it:

* **extend**: if the configurator assigns the TOP bin `extend_after` times,
  a new bin is appended (new_max = max + delta). Symmetric for the bottom bin.
* **split**: if the SAME bin is assigned `split_after` times, the bin size is
  halved globally (10 -> 20 bins the first time, as the paper describes).
* **merge**: adjacent bins that have both stayed unused for `merge_after`
  assignments (across the lever) are merged ([55]'s merge rule).
* **ridge jitter**: the emitted value is the bin centre plus a small ridge
  term (uniform in +-ridge_frac * bin width) — 'helpful for noisy cloud
  environments'; the value is clamped to the bin.

Integer and categorical levers pass through with rounding / identity.

``DeviceLeverTable`` (DESIGN.md §10) is the integerised, array-over-clusters
compilation of a ``LeverDiscretiser``: a fleet's configs become one
``(N, n_levers)`` int array of bin / category indices, and moving a lever is
pure index arithmetic — host-vectorised (``apply_host``) for the §2.1 random
sweep, or traced into the fused device training loop
(``repro_torch.core.device_loop``). The dict-based ``LeverDiscretiser`` stays the
adaptive oracle; dynamic split/merge happens host-side between episode
batches, after which the table is re-packed (``from_discretiser``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np


@dataclass
class LeverSpec:
    """Static description of one configuration lever."""

    name: str
    kind: str = "float"          # float | int | log | choice | bool
    lo: float = 0.0
    hi: float = 1.0
    choices: tuple = ()          # for kind == "choice"
    default: Optional[float] = None
    reboot: bool = False         # applying it requires an engine restart
    group: str = "misc"          # ingest | sched | memory | parallel | kernel
                                 # | precision | collective | misc
    # hard validity range (paper §2.1: 'lists of valid values or ranges were
    # generated ... based on the configuration of the underlying VMs').
    # Dynamic bin extension never crosses these. None -> 4x the initial span.
    hard_lo: Optional[float] = None
    hard_hi: Optional[float] = None

    def resolved_hard(self) -> tuple[float, float]:
        if self.kind == "log":
            lo = self.hard_lo if self.hard_lo is not None else self.lo / 4.0
            hi = self.hard_hi if self.hard_hi is not None else self.hi * 4.0
        else:
            span = self.hi - self.lo
            lo = self.hard_lo if self.hard_lo is not None else self.lo - 2 * span
            hi = self.hard_hi if self.hard_hi is not None else self.hi + 2 * span
            if self.hard_lo is None and self.lo >= 0:
                lo = max(lo, 0.0)  # physical quantities don't go negative
        return float(lo), float(hi)

    def default_value(self):
        if self.kind == "choice":
            return self.choices[0] if self.default is None else self.default
        if self.kind == "bool":
            return bool(self.default) if self.default is not None else False
        d = self.default if self.default is not None else (self.lo + self.hi) / 2
        return int(round(d)) if self.kind == "int" else float(d)


def _trailing_run(mask: np.ndarray) -> int:
    """Length of the trailing True run of a boolean sequence."""
    nz = np.nonzero(~mask)[0]
    return int(mask.size if nz.size == 0 else mask.size - 1 - nz[-1])


class DynamicBins:
    """Adaptive binning state for one continuous lever."""

    def __init__(self, spec: LeverSpec, *, n_bins: int = 10,
                 split_after: int = 5, extend_after: int = 3,
                 merge_after: int = 40, ridge_frac: float = 0.1,
                 seed: int = 0):
        assert spec.kind in ("float", "int", "log")
        self.spec = spec
        self.lo = float(spec.lo)
        self.hi = float(spec.hi)
        if spec.kind == "log":
            assert self.lo > 0, f"log lever {spec.name} needs lo > 0"
        self.split_after = split_after
        self.extend_after = extend_after
        self.merge_after = merge_after
        self.ridge_frac = ridge_frac
        self._rng = np.random.default_rng(seed)
        self._edges = self._linspace(n_bins)
        self._hits = np.zeros(n_bins, np.int64)
        self._since_used = np.zeros(n_bins, np.int64)
        self._top_streak = 0
        self._bot_streak = 0
        self._same_streak = 0
        self._last_bin = -1

    # -- representation helpers -------------------------------------------
    def _tolin(self, x: float) -> float:
        return np.log(x) if self.spec.kind == "log" else x

    def _fromlin(self, x: float) -> float:
        return float(np.exp(x)) if self.spec.kind == "log" else float(x)

    def _linspace(self, n: int) -> np.ndarray:
        return np.linspace(self._tolin(self.lo), self._tolin(self.hi), n + 1)

    @property
    def n_bins(self) -> int:
        return len(self._edges) - 1

    @property
    def delta(self) -> float:
        return float(self._edges[1] - self._edges[0])

    # -- queries ------------------------------------------------------------
    def bin_of(self, value: float) -> int:
        v = self._tolin(np.clip(value, self._fromlin(self._edges[0]),
                                self._fromlin(self._edges[-1])))
        return int(np.clip(np.searchsorted(self._edges, v, "right") - 1,
                           0, self.n_bins - 1))

    def centre(self, b: int) -> float:
        mid = 0.5 * (self._edges[b] + self._edges[b + 1])
        return self._fromlin(mid)

    def value(self, b: int, *, jitter: bool = True) -> float:
        """Bin centre + ridge jitter, clamped to the bin; int levers round."""
        b = min(max(int(b), 0), self.n_bins - 1)
        lo_e, hi_e = self._edges[b], self._edges[b + 1]
        mid = 0.5 * (lo_e + hi_e)
        if jitter and self.ridge_frac:
            mid = mid + self._rng.uniform(-1, 1) * self.ridge_frac * (hi_e - lo_e)
            mid = float(np.clip(mid, lo_e, hi_e))
        v = self._fromlin(mid)
        if self.spec.kind == "int":
            v = int(round(v))
        return v

    # -- adaptation ----------------------------------------------------------
    def record(self, b: int) -> None:
        """Account one assignment of bin b and adapt (paper's three rules)."""
        # plain-int clamp: this runs once per fleet step in the §10 replay
        # (N·S calls per episode batch), where np.clip dominates the profile
        b = min(max(int(b), 0), self.n_bins - 1)
        self._hits[b] += 1
        self._since_used += 1
        self._since_used[b] = 0

        self._top_streak = self._top_streak + 1 if b == self.n_bins - 1 else 0
        self._bot_streak = self._bot_streak + 1 if b == 0 else 0
        self._same_streak = self._same_streak + 1 if b == self._last_bin else 1
        self._last_bin = b

        hard_lo, hard_hi = self.spec.resolved_hard()
        if (self._top_streak >= self.extend_after
                and self._fromlin(self._edges[-1] + self.delta) <= hard_hi):
            self._extend(top=True)
            self._top_streak = 0
        elif (self._bot_streak >= self.extend_after
              and self._fromlin(self._edges[0] - self.delta) >= hard_lo):
            self._extend(top=False)
            self._bot_streak = 0
        if self._same_streak >= self.split_after:
            self._split()
            self._same_streak = 0
        self._maybe_merge()

    def record_many(self, bins_seq) -> None:
        """Batched ``record`` for the §10/§11 fused-loop replay: one call per
        (lever, episode batch) instead of N·S python calls.

        When NO adaptation rule can possibly fire inside the batch (checked
        conservatively from the current streak/idle counters and the batch
        length — always true for frozen-bin runs and for any batch shorter
        than the remaining thresholds), the counter updates collapse to
        vectorised numpy with an end-state IDENTICAL to the per-assignment
        loop (``tests/test_device_table.py`` pins this). Otherwise it falls
        back to that loop, preserving the exact mid-sequence split/extend/
        merge order."""
        b = np.asarray(bins_seq, np.int64)
        K = b.size
        if K == 0:
            return
        # rule feasibility mirrors record(), so saturated-but-unfireable
        # counters cannot force the per-call fallback on every batch
        # forever: extension is gated on the hard bounds (a lever pinned at
        # its bound grows an unbounded streak record() never acts on), and
        # the merge term asks whether an ADJACENT idle pair could cross the
        # threshold within this batch (a lone idle bin between two busy
        # neighbours — or any idle bin at n_bins <= 4 — can never merge,
        # however large its own counter grows)
        hard_lo, hard_hi = self.spec.resolved_hard()
        can_top = self._fromlin(self._edges[-1] + self.delta) <= hard_hi
        can_bot = self._fromlin(self._edges[0] - self.delta) >= hard_lo
        su = self._since_used
        pair_idle = (int(np.minimum(su[:-1], su[1:]).max(initial=0))
                     if self.n_bins > 4 else -10**18)
        might_adapt = (
            (can_top and self._top_streak + K >= self.extend_after)
            or (can_bot and self._bot_streak + K >= self.extend_after)
            or self._same_streak + K >= self.split_after
            or pair_idle + K >= self.merge_after)
        if might_adapt:
            for bi in b.tolist():
                self.record(bi)
            return
        b = np.clip(b, 0, self.n_bins - 1)
        np.add.at(self._hits, b, 1)
        # since_used: bins hit in the batch reset at their LAST hit position
        # (numpy fancy assignment keeps the last occurrence), others age K
        last_pos = np.full(self.n_bins, -1, np.int64)
        last_pos[b] = np.arange(K)
        self._since_used = np.where(last_pos >= 0, K - 1 - last_pos,
                                    self._since_used + K)
        # streaks: trailing-run arithmetic (a run broken inside the batch
        # restarts there; an unbroken batch continues the carried streak)
        top = self.n_bins - 1
        t_run = _trailing_run(b == top)
        self._top_streak = self._top_streak + K if t_run == K else t_run
        b_run = _trailing_run(b == 0)
        self._bot_streak = self._bot_streak + K if b_run == K else b_run
        eq_run = _trailing_run(b[1:] == b[:-1])   # internal no-change run
        if eq_run == K - 1:   # batch is one run: continue or restart at K
            self._same_streak = (self._same_streak + K
                                 if b[0] == self._last_bin else K)
        else:                 # run restarted inside the batch (streak -> 1)
            self._same_streak = eq_run + 1
        self._last_bin = int(b[-1])

    def _extend(self, top: bool) -> None:
        d = self.delta
        if top:
            self._edges = np.append(self._edges, self._edges[-1] + d)
            self._hits = np.append(self._hits, 0)
            self._since_used = np.append(self._since_used, 0)
        else:
            self._edges = np.insert(self._edges, 0, self._edges[0] - d)
            self._hits = np.insert(self._hits, 0, 0)
            self._since_used = np.insert(self._since_used, 0, 0)
            self._last_bin += 1

    def _split(self) -> None:
        """Halve the bin size: each bin becomes two (10 -> 20 the first time)."""
        mids = 0.5 * (self._edges[:-1] + self._edges[1:])
        self._edges = np.sort(np.concatenate([self._edges, mids]))
        self._hits = np.repeat(self._hits // 2, 2)
        self._since_used = np.repeat(self._since_used, 2)
        self._last_bin = min(2 * self._last_bin + 1, self.n_bins - 1)

    def _maybe_merge(self) -> None:
        """Merge the first adjacent pair that has been idle long enough."""
        if self.n_bins <= 4:
            return
        idle = self._since_used >= self.merge_after
        for i in range(self.n_bins - 1):
            if idle[i] and idle[i + 1]:
                self._edges = np.delete(self._edges, i + 1)
                self._hits[i] += self._hits[i + 1]
                self._hits = np.delete(self._hits, i + 1)
                self._since_used[i] = 0
                self._since_used = np.delete(self._since_used, i + 1)
                if self._last_bin > i:
                    self._last_bin -= 1
                return


class LeverDiscretiser:
    """Discretisation front-end over a full lever set.

    Maps (lever, direction) actions to concrete values: continuous levers move
    one bin up/down through their DynamicBins; choice/bool levers step through
    their category list.
    """

    def __init__(self, specs: Sequence[LeverSpec], *, seed: int = 0, **bin_kw):
        self.specs = {s.name: s for s in specs}
        self.bins: dict[str, DynamicBins] = {}
        for i, s in enumerate(specs):
            if s.kind in ("float", "int", "log"):
                self.bins[s.name] = DynamicBins(s, seed=seed + i, **bin_kw)

    def default_config(self) -> dict:
        return {n: s.default_value() for n, s in self.specs.items()}

    def n_choices(self, name: str) -> int:
        s = self.specs[name]
        if s.kind == "choice":
            return len(s.choices)
        if s.kind == "bool":
            return 2
        return self.bins[name].n_bins

    def apply(self, config: dict, name: str, direction: int,
              *, jitter: bool = True) -> dict:
        """Move lever `name` one step (direction ±1). Returns a new config."""
        s = self.specs[name]
        new = dict(config)
        if s.kind == "bool":
            new[name] = not bool(config[name])
            return new
        if s.kind == "choice":
            i = s.choices.index(config[name])
            new[name] = s.choices[(i + direction) % len(s.choices)]
            return new
        dyn = self.bins[name]
        b = dyn.bin_of(float(config[name]))
        b2 = int(np.clip(b + direction, 0, dyn.n_bins - 1))
        dyn.record(b2)
        b2 = min(b2, dyn.n_bins - 1)  # bins may have split/merged in record()
        new[name] = dyn.value(b2, jitter=jitter)
        return new


# --------------------------------------------------------------------------
# Integerised lever table (DESIGN.md §10)
# --------------------------------------------------------------------------

#: kind codes for the index-arithmetic apply: continuous levers CLIP at their
#: current bin range (hard bounds are baked into the bins themselves), choice
#: levers WRAP through their category cycle, bools TOGGLE regardless of
#: direction — exactly LeverDiscretiser.apply's three branches.
KIND_CLIP, KIND_WRAP, KIND_TOGGLE = 0, 1, 2


class DeviceLeverTable:
    """A ``LeverDiscretiser`` compiled to flat arrays over (lever, bin).

    Configs are ``(N, L)`` int arrays: entry ``[n, l]`` is cluster n's bin /
    category index for lever l (levers in ``self.names`` order — the
    discretiser's spec order). The table is a *frozen snapshot* of the
    discretiser's current binning: within one episode batch apply is pure
    index arithmetic; the paper's §2.4.1 split/extend/merge adaptation runs
    host-side on the oracle between batches, after which callers re-pack
    (``from_discretiser`` again) and re-index their configs.

    Values decoded from the table are jitter-free bin centres by default;
    pass ``jitter_rng`` to add the ridge term (uniform in ±ridge_frac·width,
    clamped to the bin) the oracle applies — the §2.1 sweep wants it, the
    device training loop doesn't (its equivalence tests pin bin centres).
    """

    def __init__(self, specs: Sequence[LeverSpec],
                 bins: Optional[dict] = None):
        bins = bins or {}
        self.specs = list(specs)
        self.names = [s.name for s in self.specs]
        self.index_of = {n: i for i, n in enumerate(self.names)}
        L = len(self.specs)
        n_valid = np.zeros(L, np.int32)
        kind_code = np.zeros(L, np.int32)
        ridge = np.zeros(L)
        self._edges: list[Optional[np.ndarray]] = [None] * L  # lin space
        self._choices: list[Optional[dict]] = [None] * L      # value -> idx
        for i, s in enumerate(self.specs):
            if s.kind == "bool":
                kind_code[i] = KIND_TOGGLE
                n_valid[i] = 2
            elif s.kind == "choice":
                kind_code[i] = KIND_WRAP
                n_valid[i] = len(s.choices)
                self._choices[i] = {v: j for j, v in enumerate(s.choices)}
            else:
                dyn = bins.get(s.name)
                if dyn is None:
                    dyn = DynamicBins(s)    # fresh 10-bin grid
                kind_code[i] = KIND_CLIP
                n_valid[i] = dyn.n_bins
                ridge[i] = dyn.ridge_frac
                self._edges[i] = dyn._edges.copy()
        B = int(n_valid.max())
        self.n_levers = L
        self.max_bins = B
        self.n_valid = n_valid
        self.kind_code = kind_code
        self.ridge_frac = ridge
        #: (L, B) jitter-free decoded value per bin (continuous levers only;
        #: choice/bool rows hold the category index itself). Padded slots
        #: repeat the last valid bin so a clipped gather can never read junk.
        centres = np.zeros((L, B))
        for i, s in enumerate(self.specs):
            n = int(n_valid[i])
            if self._edges[i] is not None:
                e = self._edges[i]
                mid = 0.5 * (e[:-1] + e[1:])
                v = np.exp(mid) if s.kind == "log" else mid
                if s.kind == "int":
                    v = np.round(v)
                centres[i, :n] = v
            else:
                centres[i, :n] = np.arange(n)
            centres[i, n:] = centres[i, n - 1]
        self.centres = centres

    # ------------------------------------------------------------ construction
    @classmethod
    def from_discretiser(cls, disc: LeverDiscretiser) -> "DeviceLeverTable":
        """Snapshot ``disc``'s current adaptive binning (the re-pack hook the
        device training loop calls between episode batches)."""
        return cls(list(disc.specs.values()), disc.bins)

    # --------------------------------------------------------------- indexing
    def index_configs(self, configs: Sequence[dict]) -> np.ndarray:
        """(N, L) int32 bin/category indices of N config dicts, vectorised
        per lever (matches ``DynamicBins.bin_of`` bin-for-bin)."""
        N = len(configs)
        out = np.zeros((N, self.n_levers), np.int32)
        for i, s in enumerate(self.specs):
            vals = [c[s.name] for c in configs]
            if s.kind == "bool":
                out[:, i] = np.fromiter((int(bool(v)) for v in vals), np.int32,
                                        N)
            elif s.kind == "choice":
                ch = self._choices[i]
                out[:, i] = np.fromiter((ch[v] for v in vals), np.int32, N)
            else:
                e = self._edges[i]
                v = np.asarray(vals, float)
                if s.kind == "log":
                    v = np.log(np.clip(v, np.exp(e[0]), np.exp(e[-1])))
                else:
                    v = np.clip(v, e[0], e[-1])
                out[:, i] = np.clip(np.searchsorted(e, v, "right") - 1,
                                    0, self.n_valid[i] - 1)
        return out

    def value_of(self, lever: int, b: int, rng=None):
        """Decode one (lever, bin) to the config value the oracle would emit
        (jitter-free bin centre unless ``rng`` adds the ridge term)."""
        s = self.specs[lever]
        b = min(max(int(b), 0), int(self.n_valid[lever]) - 1)
        if s.kind == "bool":
            return bool(b)
        if s.kind == "choice":
            return s.choices[b]
        e = self._edges[lever]
        mid = 0.5 * (e[b] + e[b + 1])
        if rng is not None and self.ridge_frac[lever]:
            mid += rng.uniform(-1, 1) * self.ridge_frac[lever] * (e[b + 1] - e[b])
            mid = float(np.clip(mid, e[b], e[b + 1]))
        v = float(np.exp(mid)) if s.kind == "log" else float(mid)
        return int(round(v)) if s.kind == "int" else v

    def decode_configs(self, idx: np.ndarray, rng=None) -> list[dict]:
        """(N, L) indices -> N config dicts (see ``value_of``)."""
        return [{s.name: self.value_of(l, int(row[l]), rng)
                 for l, s in enumerate(self.specs)}
                for row in np.asarray(idx)]

    # ------------------------------------------------------------------ apply
    def step_index(self, cur, lever_idx, direction, *, xp=np,
                   n_valid=None, kind_code=None):
        """New bin index for ``cur`` bins of ``lever_idx`` moved by
        ``direction`` (±1) — the pure index arithmetic shared by the host
        sweep and the traced device apply (same three branches as
        ``LeverDiscretiser.apply``). ``xp`` selects the array namespace
        (the §10 episode loop runs this with ``xp=txp`` on torch tensors,
        passing its device copies of ``n_valid``/``kind_code`` — host numpy
        arrays can't be fancy-indexed by device tensors)."""
        nv = (self.n_valid if n_valid is None else n_valid)[lever_idx]
        code = (self.kind_code if kind_code is None else kind_code)[lever_idx]
        stepped = xp.clip(cur + direction, 0, nv - 1)
        wrapped = (cur + direction) % nv
        return xp.where(code == KIND_TOGGLE, 1 - cur,
                        xp.where(code == KIND_WRAP, wrapped, stepped))

    def apply_host(self, idx: np.ndarray, lever_idx: np.ndarray,
                   direction: np.ndarray) -> np.ndarray:
        """Vectorised fleet apply: move cluster n's lever ``lever_idx[n]`` by
        ``direction[n]``. Returns a new (N, L) index array."""
        idx = np.asarray(idx)
        rows = np.arange(idx.shape[0])
        new = idx.copy()
        new[rows, lever_idx] = self.step_index(idx[rows, lever_idx],
                                               np.asarray(lever_idx),
                                               np.asarray(direction))
        return new

    # ------------------------------------------------------------------ shield
    def shield_clamp(self, new_bin, lkg_bin, radius, lever_idx, *, xp=np,
                     n_valid=None, kind_code=None):
        """Trust-region clamp over the bin lattice (DESIGN.md §16): confine
        ``new_bin`` to ±``radius`` bins around the last-known-good index
        ``lkg_bin``, intersected with the lever's valid ladder
        ``[0, n_valid - 1]``. The result is ALWAYS a valid ladder index —
        the region bounds are themselves clipped to the ladder before the
        clamp, so even an out-of-ladder ``new_bin`` (or an LKG stranded
        outside a freshly contracted region) lands inside.

        All three kind codes go through the same interval clamp: TOGGLE
        levers (2 bins) are free at any ``radius >= 1`` and pinned to LKG at
        ``radius == 0``; WRAP levers are clamped in plain index space — a
        wrap-around move at the region edge is blocked, which is the
        conservative choice for a safety shield. Shapes broadcast; ``xp``
        selects the namespace exactly like ``step_index`` (the fused episode
        loop runs this with ``xp=txp``, the host-loop oracle twin calls
        it with numpy — one implementation, repack-safe because it reads the
        ladder widths through ``n_valid`` like every other table op)."""
        nv = (self.n_valid if n_valid is None else n_valid)[lever_idx]
        lo = xp.clip(lkg_bin - radius, 0, nv - 1)
        hi = xp.clip(lkg_bin + radius, 0, nv - 1)
        return xp.clip(new_bin, lo, hi)

    def shield_mask(self, config_idx, lkg_idx, radius, ranked, *, xp=np,
                    n_valid=None, kind_code=None):
        """(N, 2·len(ranked)) bool action mask for the §16 safety shield:
        entry ``2j`` allows ranked lever j's +1 move, ``2j+1`` its -1 move —
        the action encoding ``ReinforceAgent.action_decode`` uses. A move is
        allowed when its ``step_index`` result already lies inside the
        trust region ``[lkg - radius, lkg + radius]`` (ladder-clipped), so
        the policy's probability mass reallocates to moves the hard
        ``shield_clamp`` would leave untouched. A no-op move (a WRAP lever
        blocked at the region edge still *steps*, a CLIP lever at the ladder
        end doesn't) can be masked or not — the clamp downstream is the
        guarantee, the mask is the distribution shaper."""
        ranked = xp.asarray(ranked)
        nv = (self.n_valid if n_valid is None else n_valid)[ranked]
        cur = config_idx[:, ranked]
        lkg = lkg_idx[:, ranked]
        r = radius[:, None]
        lo = xp.clip(lkg - r, 0, nv - 1)
        hi = xp.clip(lkg + r, 0, nv - 1)
        cand_p = self.step_index(cur, ranked, 1, xp=xp, n_valid=n_valid,
                                 kind_code=kind_code)
        cand_m = self.step_index(cur, ranked, -1, xp=xp, n_valid=n_valid,
                                 kind_code=kind_code)
        ok_p = (cand_p >= lo) & (cand_p <= hi)
        ok_m = (cand_m >= lo) & (cand_m <= hi)
        return xp.stack([ok_p, ok_m], axis=-1).reshape(cur.shape[0], -1)


# --------------------------------------------------------------------- shield
@dataclass(frozen=True)
class ShieldSpec:
    """Static hyper-parameters of the §16 SLO safety shield. Frozen (and so
    hashable): the fused device loop bakes the whole spec into its static
    program key — changing any field recompiles, which is the right cost
    model for knobs that alter the traced arithmetic.

    The shield state itself is four per-cluster arrays carried through the
    episode scan (and across batches): the last-known-good config indices
    ``lkg`` (N, L), the trust radius ``radius`` (N,), the breach-free streak
    ``streak`` (N,) and the breach-risk EWMA ``risk`` (N,). The per-episode
    breach budget is ephemeral — reset to ``breach_budget`` at every episode
    start inside the program."""

    trust_radius: int = 2      # initial ±bins around LKG
    radius_min: int = 1        # contraction floor (0 pins to LKG outright)
    radius_max: int = 8        # conservative-expansion ceiling
    expand_every: int = 2      # breach-free windows per +1 radius
    risk_alpha: float = 0.5    # breach-risk EWMA weight on the new window
    risk_threshold: float = 0.5  # risk above this forces fallback-to-LKG
    breach_budget: int = 4     # breached windows tolerated per episode


def shield_update(breach_frac, lkg_idx, config_idx, radius, streak, risk,
                  budget_left, spec: ShieldSpec, *, xp=np):
    """The post-window shield carry update (DESIGN.md §16) — ONE
    implementation for the fused episode loop (``xp=txp``) and the
    host-loop numpy twin. Per cluster:

    * ``risk`` <- EWMA of the window's in-trace breach fraction;
    * ``budget_left`` decrements on a breached window; exhaustion
      (``budget_out``) freezes radius expansion and (via the caller's
      fallback test) pins the cluster to LKG for the episode's remainder;
    * breached windows HALVE the trust radius (floored at ``radius_min``)
      and zero the breach-free streak; ``expand_every`` consecutive clean
      windows widen it by one bin (capped at ``radius_max``);
    * a clean window promotes the CURRENT config to last-known-good.

    Returns ``(lkg_idx, radius, streak, risk, budget_left, budget_out)``."""
    alpha = xp.asarray(spec.risk_alpha, xp.float32)
    breached = breach_frac > 0.0
    risk = (1.0 - alpha) * risk + alpha * breach_frac
    budget_left = budget_left - xp.where(breached, 1, 0)
    budget_out = budget_left <= 0
    streak2 = streak + 1
    expand = (~breached) & (streak2 >= spec.expand_every) & (~budget_out)
    radius = xp.where(breached, xp.maximum(radius // 2, spec.radius_min),
                      xp.where(expand, xp.minimum(radius + 1,
                                                  spec.radius_max), radius))
    streak = xp.where(breached | expand, 0, streak2)
    lkg_idx = xp.where(breached[:, None], lkg_idx, config_idx)
    return lkg_idx, radius, streak, risk, budget_left, budget_out
