"""horovod_tpu_torch.fleet: one GPU budget, two planes (port of
``horovod_tpu/fleet/``).

The chip-budget arbiter owns a fixed slot budget split between the
training cohort and the serving cohort and rebalances it from live
pressure signals: serving queue depth + p99 SLO breaches pull GPUs *out
of* training (graceful preemption at the next commit boundary, zero lost
steps), and a calm serving plane ebbs leased GPUs back (drain-first, zero
dropped accepted requests).

Every rebalance is a journaled **lease transfer**: the lease record lands
in the driver journal's durable ``fleet`` KV scope *before* any actuation
it authorises, term-fenced like every other control-plane mutation, so a
standby promotion mid-transfer resumes or rolls the transfer back
deterministically (docs/fault_tolerance.md "Fleet arbitration"). The
records, keys and decisions are the JAX package's.

Modules:

- ``ledger``    — the lease ledger: records, state machine, backends
- ``policy``    — the pure decision core (pressure in, Decision out)
- ``actuators`` — the desired-state writes that move slots, and the
  probes that observe the drivers
- ``arbiter``   — the control loop composing the three
- ``metrics``   — telemetry families (``hvd_fleet_*``)
- ``cli``       — the operator console (``python -m
  horovod_tpu_torch.fleet.cli``)
"""

__all__ = ["actuators", "arbiter", "cli", "ledger", "metrics",
           "policy"]
