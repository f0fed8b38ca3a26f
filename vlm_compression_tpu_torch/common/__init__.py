"""Shared helpers of the port (device policy, registry subset)."""
