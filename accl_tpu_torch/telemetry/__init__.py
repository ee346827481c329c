"""Telemetry of the port: so far the loaders of the shipped timing
model (feedback.py)."""
