"""Measurement scripts for the port on the card."""
