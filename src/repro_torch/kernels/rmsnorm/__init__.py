"""Fused residual+RMSNorm kernel."""
