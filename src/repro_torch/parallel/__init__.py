"""Parallel layout helpers of the port: the block math of shard-native
checkpoints (``parallel/sharding.py``)."""
