"""Fault tolerance on the host, counterpart of ``repro/runtime`` (its
serving part): ``fault_tolerance`` (the step watchdog and the SIGTERM
handler) and ``chaos`` (deterministic, seeded fault injection)."""
