"""Mask helpers."""
