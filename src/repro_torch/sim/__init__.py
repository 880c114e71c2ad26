"""The federated simulation grid: fleets, schedulers, dynamics, faults
and selection policies (copies of ``repro/sim``), the wire ledger and the
grid entry point (ports)."""
