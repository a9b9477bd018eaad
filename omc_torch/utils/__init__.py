"""Logging channels."""
