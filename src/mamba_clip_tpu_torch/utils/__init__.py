"""Precision policies."""
