"""The training engine."""
