"""Roofline terms for the H100: the card's constants, the analysis of a
dry-run cell, and the report tables."""
