"""Batched and video drivers of the port (one card)."""
