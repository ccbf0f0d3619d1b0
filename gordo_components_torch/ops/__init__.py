"""Tensor ops of the port: scalers and the anomaly-score kernel."""
