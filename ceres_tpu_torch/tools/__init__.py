"""Measurement scripts of the port (run on the card; nothing imports them)."""
