"""Measure models of the port (DeepFM) and their building blocks."""
