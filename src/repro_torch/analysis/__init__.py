"""Static and dispatch-time analysis: the cost model of the ops a function
runs."""
from . import costmodel

__all__ = ["costmodel"]
