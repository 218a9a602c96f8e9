"""Optimizers (``optimizers``)."""
