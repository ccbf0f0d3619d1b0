"""Anomaly detectors of the port."""
