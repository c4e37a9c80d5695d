"""Client fault model for the federated runtime: who shows up, and when.

Counterpart of ``repro.fed.faults`` (numpy only, so one seed gives the
reference's fault trace bitwise). A validated, seeded ``FaultConfig``
drives a host-side ``FaultSchedule`` that advances one per-client virtual
clock a round and emits a ``RoundPlan``: which clients attempted an upload,
which arrived before the server's deadline, and which absent clients'
cached embeddings are still inside the staleness bound. The round engine
(``core.glasu.fault_joint_inference``) reads only the plan's two ``(M,)``
mask vectors.

Semantics (as the reference's ``docs/FAULTS.md``):

  * faults hit the aggregation exchange only: every client still runs its
    Q local updates each round; an absent client is late, not idle;
  * ``present[m] = 1``: client m's upload arrived before the deadline; the
    server uses it and refreshes its cache slot;
  * ``weight[m] = 1``: client m's block (fresh, or cached within
    ``max_staleness`` rounds) enters the weighted mean; an aged-out cache
    carries weight 0;
  * a live client whose cache age reaches ``max_staleness`` forces a
    synchronous catch-up round: every live client is selected and the
    server waits for all of them.

``state()`` / ``load_state()`` round-trip the schedule through the
checkpoint's JSON sidecar.
"""
from __future__ import annotations

import math
from dataclasses import asdict, dataclass
from typing import List, NamedTuple, Optional, Sequence

import numpy as np


@dataclass(frozen=True)
class FaultConfig:
    """Validated fault-injection block (``ExperimentConfig.faults``).

    All times are VIRTUAL milliseconds — the simulation's clock, not wall
    time. The default block is the *degraded* fault model: every client
    present every round, zero latency — the fault-tolerant round path runs
    but must match the fault-free engine (the conformance baseline).
    """
    seed: int = 0
    # participation: fraction of clients the server selects per round
    participation: float = 1.0
    # upload loss: each attempted upload is dropped with this probability
    drop_prob: float = 0.0
    # server deadline per round; 0 = none (wait for every attempted upload)
    deadline_ms: float = 0.0
    # per-upload latency: base * speed_m * lognormal(sigma), heavy-tailed
    # with probability straggler_prob (Pareto(alpha) multiplier * scale)
    base_latency_ms: float = 0.0
    latency_sigma: float = 0.5
    client_speed_sigma: float = 0.0       # persistent per-client speed factor
    straggler_prob: float = 0.0
    straggler_scale: float = 10.0
    straggler_alpha: float = 1.5
    # crash/rejoin: a live client crashes with crash_prob per round and
    # stays dark for rejoin_after rounds
    crash_prob: float = 0.0
    rejoin_after: int = 5
    # hard staleness bound on cached embeddings (rounds); reaching it
    # forces a synchronous catch-up round
    max_staleness: int = 5

    def __post_init__(self):
        def err(msg):
            raise ValueError(f"FaultConfig: {msg}")

        if not (0.0 < self.participation <= 1.0):
            err(f"participation must be in (0, 1], got {self.participation}")
        if not (0.0 <= self.drop_prob < 1.0):
            err(f"drop_prob must be in [0, 1), got {self.drop_prob}")
        if self.deadline_ms < 0 or not math.isfinite(self.deadline_ms):
            err(f"deadline_ms must be finite and >= 0, got {self.deadline_ms}")
        if self.base_latency_ms < 0:
            err(f"base_latency_ms must be >= 0, got {self.base_latency_ms}")
        if self.latency_sigma < 0 or self.client_speed_sigma < 0:
            err("latency_sigma and client_speed_sigma must be >= 0")
        if not (0.0 <= self.straggler_prob <= 1.0):
            err(f"straggler_prob must be in [0, 1], got {self.straggler_prob}")
        if self.straggler_scale <= 0 or self.straggler_alpha <= 0:
            err("straggler_scale and straggler_alpha must be > 0")
        if not (0.0 <= self.crash_prob < 1.0):
            err(f"crash_prob must be in [0, 1), got {self.crash_prob}")
        if self.rejoin_after < 1:
            err(f"rejoin_after must be >= 1, got {self.rejoin_after}")
        if self.max_staleness < 1:
            err(f"max_staleness must be >= 1, got {self.max_staleness}")
        if self.drop_prob > 0.0 and self.deadline_ms == 0.0:
            err("drop_prob > 0 requires a deadline: without one the server "
                "would wait forever for a dropped upload (set deadline_ms)")

    @property
    def active(self) -> bool:
        """True when any draw can make a client absent from a round."""
        return (self.participation < 1.0 or self.drop_prob > 0.0
                or self.crash_prob > 0.0
                or (self.deadline_ms > 0.0 and self.base_latency_ms > 0.0))

    def to_dict(self) -> dict:
        return asdict(self)


class RoundPlan(NamedTuple):
    """One round's host-side fault draw (everything a backend needs)."""
    round: int
    present: np.ndarray       # (M,) float32 — upload delivered by deadline
    weight: np.ndarray        # (M,) float32 — fresh or valid-cache block
    active: np.ndarray        # (M,) bool — not crashed this round
    attempted: np.ndarray     # (M,) bool — selected & live (sent an upload)
    latency_ms: np.ndarray    # (M,) float64 — upload latency (inf: no attempt)
    t_start: float            # virtual ms at round start
    t_end: float              # virtual ms at round end
    catch_up: bool            # synchronous staleness-bound recovery round

    @property
    def n_present(self) -> int:
        return int(self.present.sum())

    @property
    def duration_ms(self) -> float:
        return self.t_end - self.t_start


def stack_plans(plans: Sequence[RoundPlan]):
    """(present (K, M), weight (K, M)) float32 stacks for the scanned step."""
    present = np.stack([p.present for p in plans]).astype(np.float32)
    weight = np.stack([p.weight for p in plans]).astype(np.float32)
    return present, weight


class FaultSchedule:
    """Sequential per-client virtual-clock engine over a ``FaultConfig``.

    ``next_round()`` advances one round: crash transitions, participation
    selection, per-upload latency draws, drop draws, deadline cut, cache
    ages, and the catch-up trigger. All state is host-side numpy; the
    device only ever sees the emitted masks.
    """

    def __init__(self, cfg: FaultConfig, n_clients: int):
        if n_clients < 1:
            raise ValueError(f"n_clients must be >= 1, got {n_clients}")
        self.cfg = cfg
        self.m = int(n_clients)
        self.rng = np.random.default_rng(cfg.seed)
        if cfg.client_speed_sigma > 0.0:
            self.speed = np.exp(cfg.client_speed_sigma
                                * self.rng.standard_normal(self.m))
        else:
            self.speed = np.ones(self.m)
        self.age = np.zeros(self.m, np.int32)       # rounds since last upload
        self.delivered_ever = np.zeros(self.m, bool)
        self.crash_until = np.zeros(self.m, np.int32)
        self.round = 0
        self.t = 0.0

    # ---------------------------------------------------------------- draws
    def _draw_latency(self, attempted: np.ndarray) -> np.ndarray:
        cfg = self.cfg
        lat = np.full(self.m, np.inf)
        if not attempted.any():
            return lat
        base = cfg.base_latency_ms * self.speed
        jitter = np.exp(cfg.latency_sigma * self.rng.standard_normal(self.m)
                        - 0.5 * cfg.latency_sigma ** 2)  # median-preserving
        draw = base * jitter
        if cfg.straggler_prob > 0.0:
            tail = self.rng.random(self.m) < cfg.straggler_prob
            mult = cfg.straggler_scale * (
                1.0 + self.rng.pareto(cfg.straggler_alpha, self.m))
            draw = np.where(tail, draw * mult, draw)
        lat[attempted] = draw[attempted]
        return lat

    # ---------------------------------------------------------------- rounds
    def next_round(self) -> RoundPlan:
        cfg, m, r = self.cfg, self.m, self.round
        # crash transitions: live clients crash with crash_prob and stay
        # dark for rejoin_after rounds (draw consumed every round so the
        # stream stays aligned whether or not anyone crashes)
        if cfg.crash_prob > 0.0:
            crash_draw = self.rng.random(m) < cfg.crash_prob
            live = self.crash_until <= r
            crashes = live & crash_draw
            self.crash_until = np.where(crashes, r + cfg.rejoin_after,
                                        self.crash_until)
        active = self.crash_until <= r

        # hard staleness bound: any live client whose cache age has reached
        # the bound forces a synchronous catch-up round NOW
        catch_up = bool(np.any(active & (self.age >= cfg.max_staleness)))

        if catch_up:
            attempted = active.copy()
            latency = self._draw_latency(attempted)
            present = attempted.copy()      # server waits for every upload
            lat_live = latency[attempted]
            duration = float(lat_live.max()) if lat_live.size else 0.0
        else:
            n_sel = max(1, int(math.ceil(cfg.participation * m)))
            sel = self.rng.choice(m, size=n_sel, replace=False)
            selected = np.zeros(m, bool)
            selected[sel] = True
            attempted = selected & active
            latency = self._draw_latency(attempted)
            dropped = attempted & (self.rng.random(m) < cfg.drop_prob)
            deadline = cfg.deadline_ms if cfg.deadline_ms > 0.0 else np.inf
            present = attempted & ~dropped & (latency <= deadline)
            if not attempted.any():
                duration = 0.0
            elif bool(np.all(present == attempted)):
                # everything arrived: the server closes the round early
                duration = float(latency[attempted].max())
                if np.isfinite(deadline):
                    duration = min(duration, float(deadline))
            else:
                # a drop or a straggler: the server waits out the deadline
                duration = float(deadline)

        # block weights: fresh, or a cache still inside the bound
        cache_ok = self.delivered_ever & (self.age <= cfg.max_staleness)
        weight = (present | cache_ok).astype(np.float32)

        self.age = np.where(present, 0, self.age + 1)
        self.delivered_ever |= present
        t_start = self.t
        self.t = t_start + duration
        self.round = r + 1
        return RoundPlan(round=r, present=present.astype(np.float32),
                         weight=weight, active=active, attempted=attempted,
                         latency_ms=latency, t_start=t_start, t_end=self.t,
                         catch_up=catch_up)

    def draw_step(self, k: int) -> List[RoundPlan]:
        """The Trainer's per-step helper: the next ``k`` rounds of plans."""
        return [self.next_round() for _ in range(k)]

    # ----------------------------------------------------------- persistence
    def state(self) -> dict:
        """JSON-serializable snapshot after ``self.round`` rounds drawn."""
        return {"rng": self.rng.bit_generator.state,
                "speed": self.speed.tolist(),
                "age": self.age.tolist(),
                "delivered_ever": self.delivered_ever.tolist(),
                "crash_until": self.crash_until.tolist(),
                "round": self.round, "t": self.t}

    def load_state(self, state: dict) -> None:
        self.rng.bit_generator.state = state["rng"]
        self.speed = np.asarray(state["speed"], np.float64)  # glint: disable=GL003 host-side schedule state, never on a device; f64 keeps the JSON round-trip bit-exact
        self.age = np.asarray(state["age"], np.int32)
        self.delivered_ever = np.asarray(state["delivered_ever"], bool)
        self.crash_until = np.asarray(state["crash_until"], np.int32)
        self.round = int(state["round"])
        self.t = float(state["t"])


def make_schedule(cfg: Optional[FaultConfig],
                  n_clients: int) -> Optional[FaultSchedule]:
    """``None``-propagating constructor (the Trainer's binding point)."""
    return None if cfg is None else FaultSchedule(cfg, n_clients)
