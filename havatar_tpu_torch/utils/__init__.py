"""Configuration nodes."""
