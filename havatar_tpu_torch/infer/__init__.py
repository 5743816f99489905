"""Reenactment inference: the per-frame pipeline."""
