"""Clustering: the balanced k-means IVF trainer."""
