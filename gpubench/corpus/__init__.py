"""Seeded corpora for the benchmark's configurations."""
