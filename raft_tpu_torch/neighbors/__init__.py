"""Neighbours: k-selection, IVF-Flat, plans, serialization."""
