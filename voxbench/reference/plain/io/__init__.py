"""Decoding the native save format (copied, cut to loading a space)."""

from .save import load_space
