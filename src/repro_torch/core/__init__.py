"""GLASU forward, evaluation tables, checkpoint restore and the
transformer serve step."""
