"""Shared helpers of the port: device policy, the registry, configs (with
the YAML-subset reader), process-group helpers, logging, profiling and
small utilities."""
