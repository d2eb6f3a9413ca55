"""Serving on the port: the KV-cache engine (``engine``), and the mapping
service (``mapper``: coalescing, the result cache, admission, degradation,
shadow verification) with its supervised worker pool (``supervisor``) and
its leaf modules (trackers, admission control, the crash-safe result
store)."""
