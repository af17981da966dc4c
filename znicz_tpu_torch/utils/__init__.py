"""Package formats and small shared utilities."""
