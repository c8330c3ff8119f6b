"""Tests of the benchmark's own code (CPU, and ``chip``-marked ones for the card)."""
