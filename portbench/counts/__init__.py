"""Work counts and the card's peaks (see work.py)."""
