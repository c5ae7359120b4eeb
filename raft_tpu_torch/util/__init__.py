"""Utilities: host-side row sampling."""
