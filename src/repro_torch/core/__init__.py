"""Codecs (``compressors``) and the shift-rule engine (``shift_rules``)."""
