"""Roofline terms of the dry-run cells (counterpart of :mod:`repro.roofline`)."""
