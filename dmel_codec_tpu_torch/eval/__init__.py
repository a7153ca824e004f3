"""Evaluation-side adapters."""
