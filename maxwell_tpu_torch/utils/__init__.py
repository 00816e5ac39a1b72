"""Utilities: fp32-true matmul precision and checkpointing."""
