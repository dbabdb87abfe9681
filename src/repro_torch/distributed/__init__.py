"""Checkpoints and the failover policy of the port (counterpart of
``repro.distributed``'s ``checkpoint`` and ``failover``; sharding and
collectives are not ported)."""
from . import checkpoint, failover

__all__ = ["checkpoint", "failover"]
