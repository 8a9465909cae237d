"""Seeded volume generators; a configuration names one by its module."""
