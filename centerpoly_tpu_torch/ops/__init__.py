"""Detection decode and gather ops."""
