"""Roofline terms of the port's dry-run (``roofline.analysis``)."""
