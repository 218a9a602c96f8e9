"""Synthetic token streams (``tokens``) and the convex problems of the
paper's experiments (``problems``)."""
