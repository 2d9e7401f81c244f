"""Benchmark presets."""
