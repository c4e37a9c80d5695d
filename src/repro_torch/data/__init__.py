"""Synthetic token data for the transformer stack (counterpart of
``repro.data``)."""
