"""Observability: the defense telemetry (obs/telemetry.py)."""
