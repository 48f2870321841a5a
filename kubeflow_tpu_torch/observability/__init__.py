"""Observability of the port: metric instruments and request timelines."""
