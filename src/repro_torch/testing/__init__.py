"""Test support shipped with the port: the differential harness and the
fault-injection audit (copies of the reference package's, pinned to them by
a test)."""
