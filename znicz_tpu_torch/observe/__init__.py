"""Telemetry plane of the port (copies of the reference's stdlib modules)."""
