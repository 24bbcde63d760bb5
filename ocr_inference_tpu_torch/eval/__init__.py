"""Synthetic pages for checks on the card (numpy only)."""
