"""Serving on the port: the KV-cache engine."""
