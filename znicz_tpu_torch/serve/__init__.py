"""Generative serving plane of the port."""
