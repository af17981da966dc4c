"""Resilience plane of the port: seeded fault injection."""
