"""Idle share of the card over the traced window of the bulk cells."""

from port_bench.readers import idle_share as read  # noqa: F401
