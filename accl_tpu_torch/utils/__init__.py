"""Shared helpers of the port."""
