"""Checkpoints, the failover policy and the numerics of compressed
gradients (counterpart of ``repro.distributed``'s ``checkpoint``,
``failover`` and the value-level half of ``collectives``; sharding and the
collectives themselves are not ported)."""
from . import checkpoint, collectives, failover

__all__ = ["checkpoint", "collectives", "failover"]
