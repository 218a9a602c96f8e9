"""Dense decoder: ``layers`` and ``model``."""
