"""The harness's own pieces, shared by every driver and cell."""
