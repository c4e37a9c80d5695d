"""GLASU forward, evaluation tables and checkpoint restore."""
