"""Validated config blocks of the embedding exchange."""
