"""Operational tooling (reference tools/: loadtest, shell helpers)."""
