"""ScenarioSpec: the campaign's deterministic scenario language.

A spec is plain data naming one point of the scenario space the
composition layer (compose.py) spans: a workload family, the generator
schedule (rate, ops per key, phase lengths), a nemesis schedule, a
cluster shape, the injectable bugs of the fake cluster
(clients/fake_kv.py) or the live minietcd fault planes
(nemesis/cluster_faults.py), and a seed. `sample_specs` is a pure
function of (n, seed, options): the same inputs give the same list,
field for field, as the JAX package's sampler does.

The families are the linearizability-checked workloads: register, gset,
queue and multiregister. `set` (durability only) and `mutex` (a
combinatorial history shape) are left out, as in the JAX package.
"""

from __future__ import annotations

import hashlib
import random
from dataclasses import asdict, dataclass, field
from typing import Any, Optional

# family -> (linearizability model, keyed under the independent wrapper?)
FAMILY_MODELS: dict[str, tuple[str, bool]] = {
    "register": ("cas-register", True),
    "gset": ("gset", False),
    "queue": ("fifo-queue", True),
    "multiregister": ("multi-register", False),
}

# Injectable-bug axes that the family's checker can actually falsify
# (a seeded bug a family cannot observe would dilute the campaign's
# falsification rate for nothing).
FAMILY_FAULTS: dict[str, tuple[str, ...]] = {
    "register": ("stale_read_prob", "lost_write_prob",
                 "duplicate_cas_prob"),
    "gset": ("stale_read_prob",),
    "queue": ("reorder_prob", "duplicate_delivery_prob"),
    "multiregister": ("stale_read_prob", "lost_write_prob"),
}

# Nemesis kinds per backend. The sim backend drives the fake store's
# fault hooks (compose.pick_nemesis fakes); the minietcd backend drives
# the new cluster fault planes (nemesis/cluster_faults.py).
SIM_NEMESES = ("noop", "partition", "partition-node", "clock")
CLUSTER_NEMESES = ("noop", "member-churn", "disk-full", "corrupt-write",
                   "lease-skew")


@dataclass(frozen=True)
class ScenarioSpec:
    """One deterministic scenario. Frozen: a spec is identity — the
    campaign report, the triage signatures and the corpus bank's
    provenance all reference it by value."""

    spec_id: int
    family: str                      # FAMILY_MODELS key
    backend: str                     # "sim" | "minietcd"
    seed: int                        # every rng in the scenario derives
    concurrency: int
    rate: float                      # Hz across all client workers
    time_limit: float                # main-phase seconds (virtual on sim)
    ops_per_key: int
    nemesis: str
    nemesis_interval: float
    recovery_wait: float
    quorum: bool
    op_delay: float                  # store-side latency (virtual) — the
    #                                  source of overlapping op windows
    faults: dict[str, float] = field(default_factory=dict)
    nodes: int = 5

    @property
    def model_name(self) -> str:
        return FAMILY_MODELS[self.family][0]

    @property
    def keyed(self) -> bool:
        return FAMILY_MODELS[self.family][1]

    def to_dict(self) -> dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ScenarioSpec":
        return cls(**{k: v for k, v in d.items()
                      if k in cls.__dataclass_fields__})

    def test_opts(self) -> dict[str, Any]:
        """The compose.fake_test / cluster-test opts this spec names.
        store_root stays None: campaign runs are checked in batch, not
        persisted one dir per scenario (the corpus bank persists what
        matters — the minimal witnesses)."""
        opts = {
            "workload": self.family,
            "seed": self.seed,
            "store_root": None,
            "concurrency": self.concurrency,
            "rate": self.rate,
            "time_limit": self.time_limit,
            "ops_per_key": self.ops_per_key,
            "recovery_wait": self.recovery_wait,
            "nemesis_interval": self.nemesis_interval,
            "quorum": self.quorum,
            "nodes": [f"n{i + 1}" for i in range(self.nodes)],
            "op_delay": self.op_delay,
            "no_nemesis": self.nemesis == "noop",
            "nemesis": "noop" if self.nemesis == "noop" else self.nemesis,
            # The batched campaign check owns the search budget; the
            # per-run composition must not also arm one.
            "check_budget_s": 0,
        }
        opts.update(self.faults)
        return opts


def spec_seed(campaign_seed: int, spec_id: int) -> int:
    """Stable per-spec seed: a hash, not campaign_seed + spec_id, so
    two campaigns at nearby seeds don't share prefix scenarios."""
    h = hashlib.sha1(f"{campaign_seed}:{spec_id}".encode()).digest()
    return int.from_bytes(h[:8], "big") & 0x7FFFFFFF


def sample_specs(n: int, seed: int,
                 families: Optional[list[str]] = None,
                 bug_rate: float = 0.25,
                 live: int = 0,
                 scale: float = 1.0) -> list[ScenarioSpec]:
    """Compose `n` deterministic scenarios. `bug_rate` is the fraction
    carrying a seeded injectable bug (the campaign's falsification
    supply); `live` caps how many run on the in-process minietcd
    cluster backend (real HTTP, real wall clock — spent on the new
    fault planes); `scale` multiplies the schedule sizes (bench lanes
    pass <1 for smoke-sized scenarios).

    Purely a function of its arguments: same (n, seed, families,
    bug_rate, live, scale) -> same list.
    """
    fams = list(families or FAMILY_MODELS)
    unknown = [f for f in fams if f not in FAMILY_MODELS]
    if unknown:
        raise ValueError(
            f"unknown campaign families {unknown}; have "
            f"{sorted(FAMILY_MODELS)}")
    rng = random.Random(seed)
    specs: list[ScenarioSpec] = []
    for i in range(n):
        family = fams[rng.randrange(len(fams))]
        # Live lane: the first `live` specs draw the cluster backend —
        # register family only (the minietcd data plane speaks the
        # register/queue v2 surface; register keeps the lane uniform).
        is_live = i < live
        backend = "minietcd" if is_live else "sim"
        if is_live:
            family = "register"
        nemeses = CLUSTER_NEMESES if is_live else SIM_NEMESES
        nemesis = nemeses[rng.randrange(len(nemeses))]
        faults: dict[str, float] = {}
        seeded_bug = rng.random() < bug_rate
        if seeded_bug and not is_live:
            axis = FAMILY_FAULTS[family][
                rng.randrange(len(FAMILY_FAULTS[family]))]
            faults[axis] = round(rng.uniform(0.15, 0.5), 3)
        elif seeded_bug and nemesis == "member-churn":
            # The live lane's seeded bugs ARE the fault planes: disk
            # faults and lease skew falsify whenever they fire, but
            # member churn is healthy by default — its bug is the
            # forked (stale-replica) standby, armed here so sampled
            # campaigns can actually reach it
            # (engine._execute_live -> MemberChurnNemesis(fork=True)).
            faults["churn_fork"] = 1.0
        specs.append(ScenarioSpec(
            spec_id=i,
            family=family,
            backend=backend,
            seed=spec_seed(seed, i),
            concurrency=rng.choice((4, 5, 8, 10)),
            rate=float(rng.choice((10, 25, 50, 100))),
            # Live scenarios pay real wall clock: keep their schedules
            # a fraction of the virtual ones' regardless of scale.
            time_limit=round((0.8 if is_live
                              else max(1.0, scale * rng.uniform(4, 12))),
                             2),
            ops_per_key=max(4, int(scale * rng.choice((10, 20, 40)))),
            nemesis=nemesis,
            # Live runs pay real wall clock on a short time_limit, so
            # the fault window must FIT: interval <= time_limit/3
            # leaves room for :start, the fault to bite, and the :stop
            # leg (the disk planes falsify only via :stop's
            # crash-restart) all inside the run. Virtual-time sims can
            # afford lazier schedules.
            nemesis_interval=round(rng.uniform(0.1, 0.25) if is_live
                                   else rng.uniform(0.5, 2.0), 2),
            recovery_wait=0.5 if not is_live else 0.1,
            quorum=bool(rng.random() < 0.3),
            op_delay=round(rng.uniform(0.0, 0.01), 4),
            faults=faults,
            nodes=rng.choice((3, 5)),
        ))
    return specs
