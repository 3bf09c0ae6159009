"""Measurement scripts of the port, run on a card; nothing imports them."""
