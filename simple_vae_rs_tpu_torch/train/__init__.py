"""Training step of the port (``Trainer``), its optimizer and configuration."""
