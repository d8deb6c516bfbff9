"""Log-bin latency histogram helpers (the plain versions; the kernel of
this name is ported with telemetry)."""
