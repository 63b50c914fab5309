"""Command-line tools over the port."""
