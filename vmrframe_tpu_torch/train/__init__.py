"""Evaluation engine (training waits for a later slice)."""
