"""Snippet inference (video and tau-strided pair steps), tube linking and
VID mAP."""
