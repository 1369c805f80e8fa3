"""The device's idle share of the traced window, in %."""

from portbench.core.trace import idle_percent as read  # noqa: F401
