"""Core plumbing of the port: config tree, logging, device policy."""
