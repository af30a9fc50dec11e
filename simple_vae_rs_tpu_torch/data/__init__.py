"""Tile datasets, the TIFF codec and the loader that feeds the card."""
