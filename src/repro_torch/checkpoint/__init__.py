"""Checkpointing of the port: the fingerprint save path, the chunk store and
the restore, writing the JAX package's on-disk format; ``StoreScrubber``
and ``scrub_root``, the store's scrub (``checkpoint/scrub.py``)."""


def __getattr__(name):
    # Imported on first use: an IO worker process imports
    # ``repro_torch.checkpoint.workers`` through this package, which must
    # import nothing (no torch) on the way.
    if name in ("StoreScrubber", "scrub_root"):
        from repro_torch.checkpoint import scrub
        return getattr(scrub, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
