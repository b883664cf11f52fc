"""Tensor parallelism (sharding rules, shard plans, reduction gates) and
gradient compression."""
