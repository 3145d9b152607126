"""Checkpointing of the port: the fingerprint save path, the chunk store and
the restore, writing the JAX package's on-disk format."""
