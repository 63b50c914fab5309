"""Geometry helpers."""
