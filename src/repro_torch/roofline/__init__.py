"""Roofline terms of a dry-run step on the H100 (``analysis``)."""
