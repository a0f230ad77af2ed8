"""Shared host utilities of the port (diagnostics, metrics, tracing)."""
