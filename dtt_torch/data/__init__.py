"""Synthetic mini-VID data (numpy only)."""
