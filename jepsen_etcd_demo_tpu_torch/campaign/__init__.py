"""campaign: the scenario factory.

The machine imagines the scenarios, runs them, checks them on the card
in corpus batches, and turns what falsifies into a regression corpus
(the JAX package's campaign/, module for module):

  * specs.py   - ScenarioSpec and its deterministic sampler over the
                 workload families, nemesis schedules, injectable bugs
                 and cluster shapes: the same seed gives the same list
  * vclock.py  - the virtual-time event loop that runs a composed fake
                 test at memory speed and deterministically: the same
                 spec gives the same history, op for op
  * cluster.py - an in-process minietcd cluster (db/minietcd.py's
                 KeyStore and handler on ephemeral ports) for live
                 specs, which the fault planes of
                 nemesis/cluster_faults.py bend
  * engine.py  - the executor: runs the specs, checks every key through
                 sched.check_corpus (or the serve scheduler's campaign
                 tenant), triages, shrinks and banks
  * triage.py  - anomaly signatures and the batched ddmin shrinker (one
                 corpus launch a round), with the cross-route check
  * bank.py    - minimal witnesses under <store>/corpus/, and their
                 replay

Every check runs on the caller's device (None = cuda); without a card
the entry points raise and never check on the host.
"""

from .bank import BankedWitness, bank_witness, load_corpus, replay_corpus
from .engine import CampaignReport, run_campaign
from .specs import ScenarioSpec, sample_specs
from .triage import Signature, classify, ddmin_shrink, verify_routes

__all__ = [
    "BankedWitness",
    "CampaignReport",
    "ScenarioSpec",
    "Signature",
    "bank_witness",
    "classify",
    "ddmin_shrink",
    "load_corpus",
    "replay_corpus",
    "run_campaign",
    "sample_specs",
    "verify_routes",
]
