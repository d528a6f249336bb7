"""Durability of the port: checkpoints and fault handling."""
