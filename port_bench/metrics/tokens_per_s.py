"""Tokens of every rank's steps in the window over its seconds."""

from port_bench.readers import rate as read  # noqa: F401
