"""Self-chaos harness: coverage-guided fault-schedule fuzzing of the
verification pipeline itself (doc/robustness.md, "Self-chaos").

The tester gets the Jepsen treatment: generate multi-event backend
fault + service lifecycle schedules, execute each against a live
``VerificationService`` running a fixed deterministic workload, and
hold the outcome to a set of oracles anchored on the uninjected solo
verdict. Coverage over (fault x site x lifecycle-state) transitions
guides the search toward the compound failure paths — fault during
recovery replay, corruption mid-failover — single-fault tests never
reach; oracle failures shrink to a minimal reproducing schedule.

The port's copy of `jepsen_tpu/chaos/`, holding the port's service on
the card (`driver.ChaosConfig.device`) to the same oracles.
"""

from .driver import (ChaosConfig, run_chaos, workload_ops,
                     workload_spec)
from .genome import (BACKEND_KINDS, LIFECYCLE_KINDS, ChaosEvent,
                     ChaosGenome, mutate, sample_genome,
                     shrink_reductions)
from .oracles import ORACLES, check_oracles, normalize_verdict

__all__ = [
    "BACKEND_KINDS", "LIFECYCLE_KINDS", "ORACLES", "ChaosConfig",
    "ChaosEvent", "ChaosGenome", "check_oracles", "mutate",
    "normalize_verdict", "run_chaos", "sample_genome",
    "shrink_reductions", "workload_ops", "workload_spec",
]
