"""Profiling and statistics helpers."""
