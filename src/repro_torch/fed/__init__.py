"""Validated config blocks of the federated runtime."""
