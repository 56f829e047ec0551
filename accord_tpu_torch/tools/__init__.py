"""Maintenance tools of the port (host-layer copy and audit)."""
