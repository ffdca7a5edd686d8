"""Solver drivers and public API (the reference L5 layer)."""
