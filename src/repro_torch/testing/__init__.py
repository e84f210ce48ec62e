"""Test support shipped with the port: the differential harness (a copy of
the reference package's, pinned to it by a test)."""
