"""Synthetic token streams (``tokens``)."""
