"""Fault tolerance."""
