"""Utilities of the port (profiling)."""
