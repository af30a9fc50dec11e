"""Tests of the port's benchmark (CPU; the `gpu`-marked ones run each cell on the card)."""
