"""Serving on the port: the KV-cache engine, and the mapping service's leaf
modules (trackers, admission control, the crash-safe result store)."""
