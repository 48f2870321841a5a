"""Observability of the port: the instruments the loop reads."""
