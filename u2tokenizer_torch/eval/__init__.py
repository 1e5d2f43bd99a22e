"""Evaluation and inference entry points of the port."""
