"""Transformer pieces the serving slice needs."""
