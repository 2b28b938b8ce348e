"""Wire-level error types.

Only ``ShedError`` so far: the planner raises it for work whose deadline
already passed. The framed RPC codec arrives with the serving stack.
"""
from __future__ import annotations


class ShedError(RuntimeError):
    """The request was shed (overload or an expired deadline); retriable."""
