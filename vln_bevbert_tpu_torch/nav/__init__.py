"""Discrete-environment navigation (eval slice)."""
