"""Decoder-only language model."""
