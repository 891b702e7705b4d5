"""Measure models of the port (DeepFM), their building blocks and the
attention layers (``layers``), and the recommendation models' embedding
ops (``recsys``)."""
