"""Checkpoints, the failover policy, the sharding rules and the
collectives (counterpart of ``repro.distributed``)."""
from . import checkpoint, collectives, failover, sharding

__all__ = ["checkpoint", "collectives", "failover", "sharding"]
